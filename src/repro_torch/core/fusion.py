"""AdaFusion: gradient-free optimization of the dual-LoRA fusion weights.

The port's own copy of ``repro/core/fusion.py`` (numpy only).

Paper §3.5 / Eq. 8: find w = (w1, w2) minimizing few-shot cross-entropy plus
an L1 penalty, **without** building a hypernetwork or backprop graph — the
search space is 2 scalars per client, so black-box search is cheap (the paper
follows LoRAHub's gradient-free approach; default budget = 5 optimization
steps as in the paper's setup).

Implemented methods:
  * ``es``           — small (μ,λ) evolution strategy with step-size decay
                       (the CMA-ES-style default, matching LoRAHub's choice)
  * ``spsa``         — simultaneous-perturbation stochastic approximation
  * ``nelder_mead``  — deterministic 2-simplex
  * ``random``/``average``/``sum`` — the paper's RQ7 baselines
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np

EvalFn = Callable[[np.ndarray], float]  # w (2,) -> few-shot CE loss


def _penalized(eval_loss: EvalFn, lam: float) -> EvalFn:
    def fn(w):
        return float(eval_loss(np.asarray(w, np.float32))) + lam * float(np.abs(w).sum())
    return fn


def adafusion(eval_loss: EvalFn, *, method: str = "es", steps: int = 5,
              population: int = 8, lam: float = 0.05, seed: int = 0,
              w0=(0.5, 0.5)) -> Tuple[np.ndarray, Dict]:
    """Returns (w_opt (2,), info dict with history)."""
    rng = np.random.default_rng(seed)
    f = _penalized(eval_loss, lam)
    w0 = np.asarray(w0, np.float32)

    if method == "average":
        w = np.array([0.5, 0.5], np.float32)
        return w, {"history": [f(w)], "evals": 1}
    if method == "sum":
        w = np.array([1.0, 1.0], np.float32)
        return w, {"history": [f(w)], "evals": 1}
    if method == "random":
        w = rng.uniform(0.0, 1.0, size=2).astype(np.float32)
        return w, {"history": [f(w)], "evals": 1}
    if method == "es":
        return _es(f, w0, rng, steps, population)
    if method == "spsa":
        return _spsa(f, w0, rng, steps)
    if method == "nelder_mead":
        return _nelder_mead(f, w0, steps)
    raise ValueError(method)


def _es(f, w0, rng, steps, population):
    """(μ,λ)-ES with recombination and exponential step-size decay."""
    mean = w0.copy()
    sigma = 0.35
    mu = max(2, population // 2)
    best_w, best_v = mean.copy(), f(mean)
    history = [best_v]
    evals = 1
    for _ in range(steps):
        cand = mean[None] + sigma * rng.standard_normal((population, 2)).astype(np.float32)
        vals = np.array([f(c) for c in cand])
        evals += population
        elite = cand[np.argsort(vals)[:mu]]
        mean = elite.mean(axis=0)
        sigma *= 0.8
        i = int(np.argmin(vals))
        if vals[i] < best_v:
            best_v, best_w = float(vals[i]), cand[i].copy()
        history.append(best_v)
    return best_w.astype(np.float32), {"history": history, "evals": evals}


def _spsa(f, w0, rng, steps, a0=0.25, c0=0.15):
    w = w0.copy()
    best_w, best_v = w.copy(), f(w)
    history = [best_v]
    evals = 1
    for k in range(steps):
        ak = a0 / (k + 1) ** 0.602
        ck = c0 / (k + 1) ** 0.101
        delta = rng.choice([-1.0, 1.0], size=2).astype(np.float32)
        vp, vm = f(w + ck * delta), f(w - ck * delta)
        evals += 2
        ghat = (vp - vm) / (2 * ck) * delta  # elementwise: delta_i^{-1}=delta_i for ±1
        w = w - ak * ghat
        v = f(w)
        evals += 1
        if v < best_v:
            best_v, best_w = v, w.copy()
        history.append(best_v)
    return best_w.astype(np.float32), {"history": history, "evals": evals}


def _nelder_mead(f, w0, steps, init_step=0.3):
    simplex = [w0.copy(), w0 + np.array([init_step, 0], np.float32),
               w0 + np.array([0, init_step], np.float32)]
    vals = [f(p) for p in simplex]
    evals = 3
    history = [min(vals)]
    for _ in range(steps):
        order = np.argsort(vals)
        simplex = [simplex[i] for i in order]
        vals = [vals[i] for i in order]
        centroid = (simplex[0] + simplex[1]) / 2
        # reflect
        xr = centroid + (centroid - simplex[2])
        fr = f(xr); evals += 1
        if fr < vals[0]:
            xe = centroid + 2 * (centroid - simplex[2])
            fe = f(xe); evals += 1
            simplex[2], vals[2] = (xe, fe) if fe < fr else (xr, fr)
        elif fr < vals[1]:
            simplex[2], vals[2] = xr, fr
        else:
            xc = centroid + 0.5 * (simplex[2] - centroid)
            fc = f(xc); evals += 1
            if fc < vals[2]:
                simplex[2], vals[2] = xc, fc
            else:  # shrink
                for i in (1, 2):
                    simplex[i] = simplex[0] + 0.5 * (simplex[i] - simplex[0])
                    vals[i] = f(simplex[i]); evals += 1
        history.append(min(vals))
    i = int(np.argmin(vals))
    return simplex[i].astype(np.float32), {"history": history, "evals": evals}
