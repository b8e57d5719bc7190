"""Open-loop trace workloads for the serving engine.

Port of ``repro/serving/trace.py`` (numpy only; it imports nothing of the
reference package).  Closed-loop batches (submit everything, wait for the
drain) measure throughput but hide what users feel: how long a request
that arrives at a bad moment waits.  This module generates seeded
open-loop traces -- requests arrive at scheduled times whether or not the
engine keeps up -- and drives a
:class:`~repro_torch.serving.engine.StreamSession` with them:

  * **TTFT** (time to first token): first emitted token's timestamp minus
    the request's SCHEDULED arrival, queueing included;
  * **TPOT** (time per output token): mean gap between tokens after the
    first, ``(t_last - t_first) / (n - 1)``;
  * **goodput**: emitted tokens over the serving window.

:func:`synth_trace` builds the workload (Poisson or bursty ON-OFF
arrivals, lognormal prompt and output lengths, priority and client mixes)
from one numpy Generator seed: for the same seed and parameters it gives
the reference's trace, bit for bit.  :func:`run_trace` replays it:

  * ``realtime=True``: arrivals at wall-clock times (scaled by
    ``time_scale``); TTFT and TPOT in milliseconds;
  * ``realtime=False`` (logical): arrival times map to engine ROUNDS
    (``rounds_per_s``), so the submission schedule and every dispatch are
    deterministic: the parity mode, where streams with
    ``ServeConfig.overlap`` on and off must be bitwise equal.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.engine import (MultiTenantEngine, Request,
                                        ServeConfig)

__all__ = ["TraceEntry", "synth_trace", "run_trace"]

# default class mix: mostly latency-sensitive traffic with a batch tail —
# the shape that makes per-class TTFT percentiles informative
DEFAULT_PRIORITY_MIX = {"interactive": 0.5, "batch": 0.35, "background": 0.15}


@dataclasses.dataclass
class TraceEntry:
    """One scheduled request: WHEN it arrives and WHAT it asks for."""
    arrival_s: float            # scheduled arrival, seconds from trace start
    client_id: Any
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int
    priority: str

    def request(self) -> Request:
        return Request(client_id=self.client_id, prompt=self.prompt,
                       max_new_tokens=self.max_new_tokens,
                       priority=self.priority)


def _poisson_arrivals(rng: np.random.Generator, n: int,
                      rate: float) -> np.ndarray:
    """n exponential inter-arrival gaps at ``rate`` req/s, cumulated."""
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def _bursty_arrivals(rng: np.random.Generator, n: int, rate: float,
                     on_s: float, off_s: float) -> np.ndarray:
    """ON-OFF (Markov-modulated Poisson) arrivals: exponential ON windows
    (mean ``on_s`` seconds) of arrivals at ``rate * (on_s + off_s) / on_s``
    req/s separated by silent exponential OFF windows (mean ``off_s``) —
    the within-burst rate is scaled so the LONG-RUN average stays ``rate``,
    which keeps Poisson and bursty traces comparable at equal load while
    the bursty one stresses admission with deep transient queues."""
    burst_rate = rate * (on_s + off_s) / on_s
    out: List[float] = []
    t = 0.0
    while len(out) < n:
        on_end = t + rng.exponential(on_s)
        while len(out) < n:
            t += rng.exponential(1.0 / burst_rate)
            if t >= on_end:
                break                     # overshoot discarded: exponential
            out.append(t)                 # memorylessness keeps rates exact
        t = on_end + rng.exponential(off_s)
    return np.asarray(out)


def _lognormal_len(rng: np.random.Generator, mean: float, sigma: float,
                   lo: int, hi: int) -> int:
    """Heavy-tail length: lognormal with MEDIAN ``mean``, clipped to
    [lo, hi] — most requests are short, a fat tail is not."""
    return int(np.clip(round(rng.lognormal(np.log(mean), sigma)), lo, hi))


def synth_trace(seed: int, n_requests: int, *,
                arrival: str = "poisson",
                rate: float = 8.0,
                burst_on_s: float = 0.5,
                burst_off_s: float = 1.5,
                prompt_mean: float = 12.0, prompt_sigma: float = 0.6,
                prompt_max: int = 48,
                out_mean: float = 8.0, out_sigma: float = 0.6,
                out_max: int = 24,
                clients: Sequence[Any] = ("c0", "c1"),
                client_weights: Optional[Sequence[float]] = None,
                priority_mix: Optional[Dict[str, float]] = None,
                vocab_size: int = 300,
                forbid_tokens: Sequence[int] = (0,),
                ) -> List[TraceEntry]:
    """A seeded open-loop workload: ``n_requests`` entries sorted by
    arrival time.  ``arrival`` is ``"poisson"`` (memoryless at ``rate``
    req/s) or ``"bursty"`` (ON-OFF bursts, same long-run ``rate``).
    Prompt/output lengths are lognormal (median ``prompt_mean`` /
    ``out_mean``, shape ``*_sigma``) clipped to ``[1, *_max]``; prompt
    tokens are uniform over ``[1, vocab_size)`` minus ``forbid_tokens``
    (keep the pad id — and the EOS id, if the engine uses one — out of
    prompts).  Same seed and parameters => the SAME trace, bit for bit."""
    if n_requests < 1:
        raise ValueError(f"n_requests must be >= 1, got {n_requests}")
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    rng = np.random.default_rng(seed)
    if arrival == "poisson":
        arrivals = _poisson_arrivals(rng, n_requests, rate)
    elif arrival == "bursty":
        arrivals = _bursty_arrivals(rng, n_requests, rate,
                                    burst_on_s, burst_off_s)
    else:
        raise ValueError(f"arrival must be 'poisson' or 'bursty', "
                         f"got {arrival!r}")
    mix = dict(priority_mix or DEFAULT_PRIORITY_MIX)
    pr_names = sorted(mix)                     # fixed draw order
    pr_w = np.asarray([mix[k] for k in pr_names], float)
    pr_w = pr_w / pr_w.sum()
    cl_w = (np.asarray(client_weights, float) / np.sum(client_weights)
            if client_weights is not None
            else np.full(len(clients), 1.0 / len(clients)))
    forbid = set(int(t) for t in forbid_tokens)
    ok = np.asarray([t for t in range(1, vocab_size) if t not in forbid],
                    np.int32)
    if ok.size == 0:
        raise ValueError("forbid_tokens leaves no valid prompt tokens")
    entries = []
    for i in range(n_requests):
        s = _lognormal_len(rng, prompt_mean, prompt_sigma, 1, prompt_max)
        b = _lognormal_len(rng, out_mean, out_sigma, 1, out_max)
        prompt = rng.choice(ok, size=s)
        cid = clients[int(rng.choice(len(clients), p=cl_w))]
        pri = pr_names[int(rng.choice(len(pr_names), p=pr_w))]
        entries.append(TraceEntry(arrival_s=float(arrivals[i]),
                                  client_id=cid,
                                  prompt=prompt.astype(np.int32),
                                  max_new_tokens=b, priority=pri))
    return entries


def _percentiles(xs: List[float]) -> Dict[str, float]:
    if not xs:
        return {"p50": 0.0, "p99": 0.0}
    return {"p50": float(np.percentile(xs, 50)),
            "p99": float(np.percentile(xs, 99))}


def _report(trace: Sequence[TraceEntry], streams: Dict[int, List[int]],
            first: Dict[int, float], last: Dict[int, float],
            arrivals: Dict[int, float], elapsed: float, unit: str,
            mode: str, last_stats: Optional[dict]) -> dict:
    """Fold per-request timestamps into the per-class SLA report.  TTFT =
    first token minus SCHEDULED arrival (queueing included); TPOT = mean
    inter-token gap after the first.  ``unit`` scales seconds -> ms in
    realtime mode; logical mode reports round counts unscaled."""
    scale = 1e3 if unit == "ms" else 1.0
    by_class: Dict[str, Dict[str, List[float]]] = {}
    for rid, e in enumerate(trace):
        if rid not in first:
            continue                      # never produced a token
        d = by_class.setdefault(e.priority, {"ttft": [], "tpot": []})
        d["ttft"].append((first[rid] - arrivals[rid]) * scale)
        n = len(streams.get(rid, []))
        if n > 1:
            d["tpot"].append((last[rid] - first[rid]) / (n - 1) * scale)
    per_class = {}
    all_ttft: List[float] = []
    all_tpot: List[float] = []
    for cls, d in sorted(by_class.items()):
        per_class[cls] = {"n": len(d["ttft"]),
                          "ttft": _percentiles(d["ttft"]),
                          "tpot": _percentiles(d["tpot"])}
        all_ttft.extend(d["ttft"])
        all_tpot.extend(d["tpot"])
    emitted = sum(len(v) for v in streams.values())
    return {"mode": mode, "unit": unit,
            "n_requests": len(trace),
            "completed": sum(1 for rid in range(len(trace))
                             if len(streams.get(rid, [])) > 0),
            "emitted_tokens": emitted,
            "elapsed": float(elapsed),
            "goodput_tok_per_unit": emitted / max(elapsed, 1e-9),
            "ttft": _percentiles(all_ttft),
            "tpot": _percentiles(all_tpot),
            "per_class": per_class,
            "streams": {rid: list(v) for rid, v in streams.items()},
            "last_stats": last_stats}


def run_trace(engine: MultiTenantEngine, sc: ServeConfig,
              trace: Sequence[TraceEntry], *,
              realtime: bool = False, time_scale: float = 1.0,
              rounds_per_s: float = 8.0) -> dict:
    """Replay ``trace`` open-loop against ``engine`` and report SLA stats.

    ``realtime=True``: entry ``i`` is submitted once wall-clock time
    passes ``arrival_s * time_scale`` (``time_scale < 1`` compresses a
    long trace into a short run at proportionally higher load); TTFT and
    TPOT come back in milliseconds, goodput in tokens/second, and
    ``last_stats`` carries wall-clock queue-wait percentiles per class.

    ``realtime=False`` (logical): entry ``i`` is submitted before engine
    round ``ceil(arrival_s * rounds_per_s)`` — no clocks anywhere, so two
    runs over the same trace execute IDENTICAL dispatch sequences (this
    is what makes async-vs-sync bitwise parity testable); TTFT/TPOT are
    reported in rounds, goodput in tokens/round.

    Returns the report dict (see ``_report``): per-class TTFT/TPOT
    p50/p99, goodput, per-request token ``streams`` keyed by rid (rids
    follow trace order), and the session's ``last_stats``."""
    order = sorted(range(len(trace)), key=lambda i: trace[i].arrival_s)
    if list(order) != list(range(len(trace))):
        raise ValueError("trace entries must be sorted by arrival_s")
    ses = engine.session(sc)
    pending = deque(enumerate(trace))
    streams: Dict[int, List[int]] = {}
    first: Dict[int, float] = {}
    last: Dict[int, float] = {}
    arrivals: Dict[int, float] = {}

    def _observe(events, now):
        for rid, toks, _fin in events:
            if toks and rid not in first:
                first[rid] = now
            if toks:
                last[rid] = now
                streams.setdefault(rid, []).extend(toks)

    if realtime:
        t0 = time.monotonic()
        while pending or ses.has_work:
            now = time.monotonic() - t0
            while pending and pending[0][1].arrival_s * time_scale <= now:
                rid, e = pending.popleft()
                sched_t = t0 + e.arrival_s * time_scale
                got = ses.submit(e.request(), arrival_time=sched_t)
                assert got == rid, (got, rid)
                arrivals[rid] = e.arrival_s * time_scale
            if not ses.has_work:
                # idle: sleep toward the next scheduled arrival instead of
                # spinning (open-loop idle gaps are part of the workload)
                gap = (pending[0][1].arrival_s * time_scale
                       - (time.monotonic() - t0))
                if gap > 0:
                    time.sleep(min(gap, 0.005))
                continue
            _observe(ses.step(), time.monotonic() - t0)
        elapsed = time.monotonic() - t0
        unit, mode = "ms", "realtime"
    else:
        rnd = 0
        while pending or ses.has_work:
            while (pending
                   and pending[0][1].arrival_s * rounds_per_s <= rnd):
                rid, e = pending.popleft()
                got = ses.submit(e.request())
                assert got == rid, (got, rid)
                arrivals[rid] = float(rnd)
            if not ses.has_work:
                # jump straight to the next arrival's round — idle rounds
                # run no dispatch and draw nothing from the generator, so
                # skipping them is invisible to the token streams
                rnd = int(np.ceil(pending[0][1].arrival_s * rounds_per_s))
                continue
            _observe(ses.step(), float(rnd))
            rnd += 1
        elapsed = float(rnd)
        unit, mode = "rounds", "logical"
    stats = ses.finalize()
    return _report(trace, streams, first, last, arrivals, elapsed, unit,
                   mode, stats)
