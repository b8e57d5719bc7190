"""The paper's six comparison baselines at the LoRA-adapter level (the base
LLM is frozen everywhere, as in the paper's PEFT setting).

Port of ``repro/federated/baselines.py``: ``Local`` plus FedAvg, FedProx,
FedAMP, FedRep, FedRoD and FedKD, each with the reference's seeds, rounds,
communication count and optimizer (AdamW, global-norm clip 1.0).  Methods
defined for full models are expressed over adapter trees; FedRoD's two
heads and FedKD's student/teacher compose adapters additively by exact LoRA
*rank concatenation* ``(A1|A2)(B1;B2) = A1B1 + A2B2``, at the config's
scale α / ``cfg.lora_rank`` whatever the concatenated rank.

Clients run one after another on one device.  Gradients come from
``torch.autograd.grad`` over the adapter leaves only.  Every class runs on
the card unless the caller asks for the CPU; ``paged_backend`` picks the
kernels (``None``: ``"cuda"`` on a card, where every projection of a step
runs the LoRA kernel, at rank 2r for FedRoD's concatenation and r/2 for
FedKD's student, and every attention the flash-attention kernel).  The
MoE router's aux loss enters where the reference adds it: through
``make_lora_loss_fn`` (FedProx, FedAMP) and in FedRoD's loss (FedKD's
has none); a dense model's is 0.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.lora import (init_adapters, lora_scale, tree_add,
                                   tree_leaves, tree_mean, tree_scale)
from repro_torch.models.model import resolve_backend
from repro_torch.training.optimizers import (adamw, apply_updates,
                                             clip_by_global_norm)
from repro_torch.training.train_step import (cross_entropy,
                                             make_lora_loss_fn,
                                             make_lora_train_step,
                                             value_and_grad)

Params = Any


def concat_rank(ad1: Params, ad2: Params) -> Params:
    """Exact additive composition of two LoRAs via rank concatenation."""
    def walk(a, b):
        if isinstance(a, dict) and set(a.keys()) == {"a", "b"}:
            return {"a": torch.cat([a["a"], b["a"]], dim=-1),
                    "b": torch.cat([a["b"], b["b"]], dim=-2)}
        if isinstance(a, (list, tuple)):
            return [walk(x, y) for x, y in zip(a, b)]
        return {k: walk(a[k], b[k]) for k in a}

    return walk(ad1, ad2)


@dataclasses.dataclass
class FedConfig:
    n_clients: int = 5
    rounds: int = 30
    local_steps: int = 3
    lr: float = 2e-4
    seed: int = 0
    # method-specific knobs
    prox_mu: float = 0.01            # FedProx
    amp_lambda: float = 0.1          # FedAMP prox to the attentive aggregate
    amp_tau: float = 5.0             # FedAMP attention temperature
    kd_temp: float = 2.0             # FedKD distillation temperature
    kd_coef: float = 0.5


def _sq_dist(x: Params, y: Params) -> torch.Tensor:
    """Σ over leaves of ‖x − y‖²."""
    return sum(torch.sum(torch.square(a - b)) for (_, a), (_, b) in
               zip(tree_leaves(x), tree_leaves(y)))


class BaselineBase:
    name = "base"

    def __init__(self, model, cfg, fed: FedConfig, base_params,
                 device="cuda", paged_backend: Optional[str] = None):
        self.device = resolve_device(device)
        self.paged_backend = resolve_backend(cfg, paged_backend,
                                             self.device).paged_backend
        self.model, self.cfg, self.fed = model, cfg, fed
        self.base = base_params
        self.scale = lora_scale(cfg)
        self.opt = adamw(lr=fed.lr)
        self.comm_bytes = 0.0

    def _dev(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    def _init_all(self) -> List[Params]:
        return [init_adapters(self.cfg, seed=self.fed.seed * 100 + i,
                              device=self.device)
                for i in range(self.fed.n_clients)]

    def _count(self, tree):
        self.comm_bytes += float(sum(t.numel() * t.element_size()
                                     for _, t in tree_leaves(tree)))

    def _forward(self, adapters, batch):
        return self.model.forward(self.base, batch, adapters=adapters,
                                  lora_scale=self.scale,
                                  paged_backend=self.paged_backend)

    def _train_step(self) -> Callable:
        """The plain SFT step: step(params, adapters, state, batch)."""
        return make_lora_train_step(self.model, self.cfg, self.opt,
                                    paged_backend=self.paged_backend)

    def _make_step(self, loss_fn) -> Callable:
        """step(trees, state, batch, *extra) -> (trees', state', metrics)
        for ``loss_fn(trees, base, batch, *extra) -> (loss, metrics)``:
        the gradient in every leaf of ``trees``, the global-norm clip, then
        AdamW over all of them (a pair of trees comes back as a list)."""
        vg = value_and_grad(loss_fn)

        def step(trees, st, batch, *extra):
            _, m, grads = vg(trees, self.base, batch, *extra)
            grads = clip_by_global_norm(grads, 1.0)
            upd, st = self.opt.update(grads, st, trees)
            return apply_updates(trees, upd), st, m

        return step

    def fit(self, batchers) -> List[Params]:
        raise NotImplementedError


class Local(BaselineBase):
    """Per-client training only — no communication at all."""
    name = "local"

    def fit(self, batchers):
        step = self._train_step()
        ads = self._init_all()
        states = [self.opt.init(a) for a in ads]
        for _ in range(self.fed.rounds):
            for i in range(self.fed.n_clients):
                for _ in range(self.fed.local_steps):
                    ads[i], states[i], _ = step(self.base, ads[i], states[i],
                                                self._dev(batchers[i].sample()))
        return ads


class FedAvg(BaselineBase):
    """McMahan et al. 2017 over LoRA parameters."""
    name = "fedavg"

    def fit(self, batchers):
        step = self._train_step()
        g = init_adapters(self.cfg, seed=self.fed.seed, device=self.device)
        states = [self.opt.init(g) for _ in range(self.fed.n_clients)]
        for _ in range(self.fed.rounds):
            locals_ = []
            for i in range(self.fed.n_clients):
                a = g
                self._count(g)  # broadcast down
                for _ in range(self.fed.local_steps):
                    a, states[i], _ = step(self.base, a, states[i],
                                           self._dev(batchers[i].sample()))
                locals_.append(a)
                self._count(a)  # upload
            g = tree_mean(locals_)
        return [g] * self.fed.n_clients


class FedProx(BaselineBase):
    """Li et al. 2020: local loss + (μ/2)·‖θ − θ_global‖²."""
    name = "fedprox"

    def loss_fn(self) -> Callable:
        """(ad, base, batch, g) -> (loss, metrics)."""
        loss_fn = make_lora_loss_fn(self.model, self.cfg, self.paged_backend)
        mu = self.fed.prox_mu

        def prox_loss(ad, base, batch, g):
            l, m = loss_fn(ad, base, batch)
            return l + 0.5 * mu * _sq_dist(ad, g), m

        return prox_loss

    def fit(self, batchers):
        step = self._make_step(self.loss_fn())
        g = init_adapters(self.cfg, seed=self.fed.seed, device=self.device)
        states = [self.opt.init(g) for _ in range(self.fed.n_clients)]
        for _ in range(self.fed.rounds):
            locals_ = []
            for i in range(self.fed.n_clients):
                a = g
                self._count(g)
                for _ in range(self.fed.local_steps):
                    a, states[i], _ = step(a, states[i],
                                           self._dev(batchers[i].sample()), g)
                locals_.append(a)
                self._count(a)
            g = tree_mean(locals_)
        return [g] * self.fed.n_clients


class FedAMP(BaselineBase):
    """Huang et al. 2021: attentive message passing — each client gets a
    personalized aggregate u_i = Σ_j ξ_ij θ_j (ξ from parameter cosine
    similarity) and trains with a prox toward u_i."""
    name = "fedamp"

    def _attention(self, thetas: List[Params]) -> List[Params]:
        n = len(thetas)
        flats = [torch.cat([x.reshape(-1) for _, x in tree_leaves(t)])
                 for t in thetas]
        normed = [f / (torch.linalg.vector_norm(f) + 1e-9) for f in flats]
        sims = np.array([[float(torch.dot(normed[i], normed[j]))
                          for j in range(n)] for i in range(n)])
        out = []
        for i in range(n):
            logits = self.fed.amp_tau * sims[i]
            w = np.exp(logits - logits.max())
            w = w / w.sum()
            agg = tree_scale(thetas[0], float(w[0]))
            for j in range(1, n):
                agg = tree_add(agg, tree_scale(thetas[j], float(w[j])))
            out.append(agg)
        return out

    def loss_fn(self) -> Callable:
        """(ad, base, batch, u) -> (loss, metrics)."""
        loss_fn = make_lora_loss_fn(self.model, self.cfg, self.paged_backend)
        lam = self.fed.amp_lambda

        def amp_loss(ad, base, batch, u):
            l, m = loss_fn(ad, base, batch)
            return l + 0.5 * lam * _sq_dist(ad, u), m

        return amp_loss

    def fit(self, batchers):
        step = self._make_step(self.loss_fn())
        ads = self._init_all()
        states = [self.opt.init(a) for a in ads]
        for _ in range(self.fed.rounds):
            us = self._attention(ads)          # server message passing
            for u in us:
                self._count(u)
            for i in range(self.fed.n_clients):
                self._count(ads[i])
                for _ in range(self.fed.local_steps):
                    ads[i], states[i], _ = step(
                        ads[i], states[i], self._dev(batchers[i].sample()),
                        us[i])
        return ads


_REP_SHARED = ("mixer", "self_attn", "cross_attn")


def _split_rep_head(ad: Params):
    """FedRep split: attention ('representation') adapters are shared,
    MLP ('head') adapters stay personal (adapter-level analog of the
    body/head decoupling).  The walk goes through the per-layer list, which
    keeps its length (a layer with no part of one kind is an empty dict),
    so layer i stays layer i."""
    def walk(t, keep):
        if isinstance(t, list):
            return [walk(v, keep) for v in t]
        out = {}
        for k, v in t.items():
            if k in _REP_SHARED:
                if keep == "shared":
                    out[k] = v
            elif k == "mlp":
                if keep == "head":
                    out[k] = v
            elif isinstance(v, (dict, list)):
                sub = walk(v, keep)
                if sub:
                    out[k] = sub
        return out

    return walk(ad, "shared"), walk(ad, "head")


def _merge_rep_head(shared: Params, head: Params) -> Params:
    def walk(s, h):
        if isinstance(s, list):
            return [walk(x, y) for x, y in zip(s, h)]
        out = dict(s) if s else {}
        for k, v in (h or {}).items():
            if (k in out and isinstance(v, (dict, list))
                    and not (isinstance(v, dict) and set(v) == {"a", "b"})):
                out[k] = walk(out[k], v)
            else:
                out[k] = v
        return out

    return walk(shared, head)


class FedRep(BaselineBase):
    """Collins et al. 2021: shared representation, personal heads.  Each
    client keeps its optimizer state across the merge, as the reference
    does."""
    name = "fedrep"

    def fit(self, batchers):
        step = self._train_step()
        ads = self._init_all()
        states = [self.opt.init(a) for a in ads]
        for _ in range(self.fed.rounds):
            for i in range(self.fed.n_clients):
                for _ in range(self.fed.local_steps):
                    ads[i], states[i], _ = step(self.base, ads[i], states[i],
                                                self._dev(batchers[i].sample()))
            shared = tree_mean([_split_rep_head(a)[0] for a in ads])
            self._count(shared)
            for i in range(self.fed.n_clients):
                ads[i] = _merge_rep_head(shared, _split_rep_head(ads[i])[1])
        return ads


class FedRoD(BaselineBase):
    """Chen & Chao 2021: decoupled generic + personalized predictors.
    Generic adapter g is FedAvg'd; personal adapter p_i trains on top via
    exact rank concatenation. Local loss = CE(g) + CE(g ⊕ p_i)."""
    name = "fedrod"

    def loss_fn(self) -> Callable:
        """((g, p), base, batch) -> (loss, metrics)."""
        def loss_fn(both, base, batch):
            g, p = both
            lg, aux1 = self._forward(g, batch)
            l1, _ = cross_entropy(self.cfg, lg, batch)
            lp, aux2 = self._forward(concat_rank(g, p), batch)
            l2, m2 = cross_entropy(self.cfg, lp, batch)
            return l1 + l2 + self.cfg.router_aux_loss_coef * (aux1 + aux2), m2

        return loss_fn

    def fit(self, batchers):
        step = self._make_step(self.loss_fn())
        g = init_adapters(self.cfg, seed=self.fed.seed, device=self.device)
        ps = self._init_all()
        states = [self.opt.init((g, p)) for p in ps]
        for _ in range(self.fed.rounds):
            locals_ = []
            for i in range(self.fed.n_clients):
                gi = g
                self._count(g)
                for _ in range(self.fed.local_steps):
                    (gi, ps[i]), states[i], _ = step(
                        (gi, ps[i]), states[i],
                        self._dev(batchers[i].sample()))
                locals_.append(gi)
                self._count(gi)
            g = tree_mean(locals_)
        self._final_g = g
        return [concat_rank(g, p) for p in ps]


class FedKD(BaselineBase):
    """Wu et al. 2022: communication-efficient FL via mutual knowledge
    distillation — a small *student* adapter (rank r/2) is the only thing
    communicated; the local *teacher* learns from data + the student and
    vice versa. (The paper's SVD gradient compression is orthogonal to the
    adapter setting and omitted, as in the reference.)"""
    name = "fedkd"

    def loss_fn(self) -> Callable:
        """((teacher, student), base, batch) -> (loss, metrics)."""
        T = self.fed.kd_temp
        coef = self.fed.kd_coef

        def kl(p_logits, q_logits, mask):
            p = torch.log_softmax(p_logits / T, -1)
            q = torch.log_softmax(q_logits / T, -1)
            per = torch.sum(torch.exp(p) * (p - q), -1)
            return (per * mask).sum() / torch.clamp(mask.sum(), min=1.0)

        def loss_fn(both, base, batch):
            t, s = both
            lt, _ = self._forward(t, batch)
            ls, _ = self._forward(s, batch)
            l1, m = cross_entropy(self.cfg, lt, batch)
            l2, _ = cross_entropy(self.cfg, ls, batch)
            mask = (batch["tokens"][:, 1:] >= 0).float()
            # each side distils from the other's detached logits
            mutual = (kl(lt[:, :-1].detach(), ls[:, :-1], mask)
                      + kl(ls[:, :-1].detach(), lt[:, :-1], mask))
            return l1 + l2 + coef * mutual, m

        return loss_fn

    def fit(self, batchers):
        r_s = max(2, self.cfg.lora_rank // 2)
        step = self._make_step(self.loss_fn())
        teachers = self._init_all()
        s_g = init_adapters(self.cfg, rank=r_s, seed=self.fed.seed + 1,
                            device=self.device)
        states = [self.opt.init((t, s_g)) for t in teachers]
        for _ in range(self.fed.rounds):
            studs = []
            for i in range(self.fed.n_clients):
                s = s_g
                self._count(s_g)
                for _ in range(self.fed.local_steps):
                    (teachers[i], s), states[i], _ = step(
                        (teachers[i], s), states[i],
                        self._dev(batchers[i].sample()))
                studs.append(s)
                self._count(s)
            s_g = tree_mean(studs)
        return teachers


BASELINES = {b.name: b for b in
             (Local, FedAvg, FedProx, FedAMP, FedRep, FedRoD, FedKD)}
