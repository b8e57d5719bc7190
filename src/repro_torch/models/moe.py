"""Mixture-of-Experts layer: top-k routing with capacity-based dispatch.

Port of ``repro/models/moe.py``.  The dispatch is sort-based, as in the
reference:

  1. the router gives each token its top-k expert ids and weights,
  2. the T·k token copies are sorted by expert id (a stable sort),
  3. each copy's slot within its expert comes from its expert's segment
     start in the sorted order,
  4. copies scatter into a padded ``(E·cap + 1, d)`` buffer, copies past
     an expert's capacity to the last row, which is dropped,
  5. the expert FFN runs batched over the experts, ``(E, cap, d) @ (E,
     d, ff)``,
  6. outputs gather back and combine with the router weights.

Capacity counts every token of the dispatch, padding and idle slots
included (``T = B·S``), and earlier flat positions win slots first: a
request's output depends on the make-up of its batch, in the reference as
here.  Shapes depend only on (T, k, E), so the dispatch makes no host
round trip.  The routing, dispatch and expert products are plain torch on
both backends (plain jnp outside any kernel in the reference); the
router's LoRA goes through the plain ``layers.lora_delta``, as the
reference's does.

Over a mesh (``apply_moe(tp=, dp=)``) the layer is the reference's
meshless layer over the whole batch, as GSPMD runs it:

* ``tp``, a ``"model"`` group: the experts split in contiguous blocks
  (expert parallelism; ``moe_specs``).  The router is replicated and its
  input whole on every rank, so every rank routes every token alike and
  plans the same dispatch over all E experts; it fills and multiplies
  only its own experts' rows of the buffer, and its combine, a partial of
  the fp32 output, is summed over the group in fp32, then cast once.
* ``dp``, the ranks that split the batch's rows: each rank routes its
  rows, then gathers every rank's (T_local, k) ids, so the dispatch, and
  with it each copy's slot, the keep mask and the capacity (of the
  global T), are the reference's; the rank runs its own rows' copies.
  The aux loss is the global batch's: one sum of a (2, E) buffer over
  the group (``need_aux=False`` skips it where the aux loss is dropped).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.partition import P
from repro_torch.models import tensor_parallel as tpl
from repro_torch.models.layers import (MODEL, DualPair, lora_delta, lora_pair,
                                       matmul)

Params = Dict[str, Any]


def init_moe(normal, d: int, ff: int, n_experts: int, mlp_type: str,
             experts: Optional[range] = None) -> Params:
    """One MoE layer's weights with the reference's scales: ``normal(shape,
    std, out_dtype=None)`` draws (``out_dtype`` None: the parameter
    dtype).  The router stays fp32.  Expert stacks are drawn an expert at
    a time, so the fp32 draw of a stack (22.5 GB for one of kimi-k2's) is
    never held whole; ``experts`` (a range of ids) keeps only those, every
    expert still drawn in turn, so they are the whole stack's rows."""
    keep = range(n_experts) if experts is None else experts

    def stack(shape, std):
        out = None
        for e in range(n_experts):
            w = normal(shape, std)
            if e in keep:
                if out is None:
                    out = w.new_empty((len(keep),) + shape)
                out[e - keep.start] = w
        return out

    p = {"router": normal((d, n_experts), d ** -0.5, torch.float32),
         "w_up": stack((d, ff), d ** -0.5),
         "w_out": stack((ff, d), ff ** -0.5)}
    if mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = stack((d, ff), d ** -0.5)
    return p


def moe_specs(mlp_type: str) -> Params:
    """Experts on the model axis; the router replicated."""
    p = {"router": P(None, None),
         "w_up": P(MODEL, None, None),
         "w_out": P(MODEL, None, None)}
    if mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = P(MODEL, None, None)
    return p


def capacity(T: int, k: int, E: int, factor: float) -> int:
    """Slots per expert: ``max(k, round(T·k/E·factor))`` (Python's round)
    rounded up to a multiple of 64, as the reference sizes it."""
    cap = int(max(k, round(T * k / E * factor)))
    return -(-cap // 64) * 64


def _top_k_routing(router_logits: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(T, E) -> weights (T, k), ids (T, k), the Switch load-balance aux
    loss.  Ties go to the lower expert id, as ``jax.lax.top_k`` breaks
    them (a stable descending sort cut to k)."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    weights, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = weights[:, :k], ids[:, :k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    E = router_logits.shape[-1]
    density = torch.mean(F.one_hot(ids[:, 0], E).float(), dim=0)
    density_proxy = torch.mean(probs, dim=0)
    aux = torch.sum(density * density_proxy) * E
    return weights, ids, aux


def dispatch(ids: torch.Tensor, E: int, cap: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ids (T, k) -> (dest (T·k,), keep (T·k,)): each copy's buffer row
    (``expert·cap + slot``; ``E·cap`` for a dropped copy) and whether it
    fits.  A copy's slot is its rank among its expert's copies in flat
    order (the stable sort keeps earlier tokens first)."""
    flat_ids = ids.reshape(-1)
    n = flat_ids.numel()
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    seg_start = torch.searchsorted(
        sorted_ids, torch.arange(E, dtype=sorted_ids.dtype,
                                 device=ids.device))
    slot_sorted = (torch.arange(n, device=ids.device)
                   - seg_start[sorted_ids])
    slot = torch.empty_like(slot_sorted)
    slot[order] = slot_sorted
    keep = slot < cap
    dest = torch.where(keep, flat_ids * cap + slot,
                       torch.full_like(slot, E * cap))
    return dest, keep


# the RoutingLogs open in this process, outermost first
_OPEN_LOGS: List["RoutingLog"] = []


class RoutingLog:
    """Every routing and dispatch :func:`apply_moe` makes in this process
    while it is open (a context manager, for checks that hold routing
    equal across backends, ranks or meshes): ``logits`` and ``ids``, each
    routing call's router logits (fp32) and own top-k ids; ``dispatched``
    and ``keep``, each dispatch's ids (at ``"data"`` > 1 every rank's,
    gathered) and keep mask; all in call (layer) order.  With ``pinned``
    (one ids tensor per routing call) each call routes to those ids
    instead, weighted by its own probabilities there, renormalised as
    top-k weights are.  It swaps this module's ``_top_k_routing`` and
    ``dispatch`` while open and restores them on exit.

    A period that activation recomputation runs again in backward
    (:func:`replays_routing`) repeats its forward's calls: they log
    nothing and route to the pins of the calls they repeat."""

    def __init__(self, pinned=None):
        self.pinned = pinned
        self.logits, self.ids, self.dispatched, self.keep = [], [], [], []
        # while a period is recomputed: the index of the next routing call
        # it repeats
        self._replay = None

    @property
    def dropped(self):
        """Each dispatch's count of dropped copies."""
        return [int((~k).sum()) for k in self.keep]

    def __enter__(self):
        global _top_k_routing, dispatch
        self._saved = _top_k_routing, dispatch
        _top_k_routing, dispatch = self._route, self._dispatch
        _OPEN_LOGS.append(self)
        return self

    def __exit__(self, *exc):
        global _top_k_routing, dispatch
        _top_k_routing, dispatch = self._saved
        _OPEN_LOGS.remove(self)

    def _route(self, logits, k):
        w, ids, aux = self._saved[0](logits, k)
        if self._replay is None:
            self.logits.append(logits.detach().float().clone())
            self.ids.append(ids.clone())
            i = len(self.ids) - 1
        else:
            i, self._replay = self._replay, self._replay + 1
        if self.pinned is not None:
            ids = self.pinned[i]
            w = torch.softmax(logits.float(), dim=-1).gather(1, ids)
            w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        return w, ids, aux

    def _dispatch(self, ids, E, cap):
        dest, keep = self._saved[1](ids, E, cap)
        if self._replay is None:
            self.dispatched.append(ids.clone())
            self.keep.append(keep.clone())
        return dest, keep


def replays_routing(fn: Callable) -> Callable:
    """``fn`` (a period of layers) as ``torch.utils.checkpoint`` calls it:
    the first call is the forward, and each later one recomputes it in a
    backward.  A recomputation replays every open :class:`RoutingLog`
    from where that log stood when the forward began: its routing calls
    take the pins of the calls they repeat, and nothing is logged again.
    A pinning log closed before that backward raises: the period would
    route by its own logits there, not as its forward did."""
    marks = None

    def run(*args):
        nonlocal marks
        if marks is None:
            marks = [(log, len(log.ids)) for log in _OPEN_LOGS]
            return fn(*args)
        for log, _ in marks:
            if log.pinned is not None and log not in _OPEN_LOGS:
                raise RuntimeError("a pinning RoutingLog was closed before "
                                   "the backward of a period it pinned")
        for log, at in marks:
            log._replay = at
        try:
            return fn(*args)
        finally:
            for log, _ in marks:
                log._replay = None
    return run


class _BmmF32(torch.autograd.Function):
    """``aten::bmm.dtype`` (bf16 operands, fp32 result) with a backward,
    which autograd lacks for that overload: each operand's gradient is a
    bf16 product of the other operand and the fp32 output gradient
    rounded to bf16, accumulated in fp32 and returned in the operand's
    dtype, with no fp32 copy of an expert stack."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g.to(b.dtype), b.transpose(1, 2),
                           out_dtype=torch.float32).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.bmm(a.transpose(1, 2), g.to(a.dtype),
                           out_dtype=torch.float32).to(b.dtype)
        return ga, gb


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b accumulated and returned in fp32 (the reference's
    ``preferred_element_type=float32``).  bf16 operands on a card use
    ``aten::bmm.dtype``, which multiplies bf16 into fp32 without an fp32
    copy of the expert stack (so does the meta device, which walks the
    card's path); elsewhere the operands go to fp32 (exact for bf16
    values)."""
    if (a.dtype != torch.float32 and (a.is_cuda or a.is_meta)
            and "dtype" in torch.ops.aten.bmm.overloads()):
        return _BmmF32.apply(a, b)
    return torch.bmm(a.float(), b.float())


def _router_delta(adapters, x, adapter_ids):
    """The router's fp32 LoRA update through the plain ``lora_delta`` on
    both backends (an Eq. 7 pair of pairs is merged first), or None."""
    lora = lora_pair(adapters, "router")
    if lora is None:
        return None
    if isinstance(lora, DualPair):
        lora = lora.merged()
    return lora_delta(x, lora.a, lora.b, adapter_ids, lora.a_scale,
                      lora.b_scale)


def apply_moe(params: Params, x: torch.Tensor, cfg,
              adapters: Optional[Params] = None, lora_scale: float = 1.0,
              adapter_ids: Optional[torch.Tensor] = None, tp=None, dp=None,
              need_aux: bool = True
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x (B, S, d) -> (out (B, S, d) in x's dtype, aux loss fp32 scalar).
    ``adapters`` may hold a ``"router"`` LoRA (the only MoE target; a
    bank with ``adapter_ids`` routes each row to its client's).

    ``tp`` (``tensor_parallel.ModelGroup``): the expert stacks are this
    rank's block of ``n_experts / size`` experts and ``x`` is whole; the
    output is the whole layer's on every rank, and so is the aux loss,
    whose gradient is scaled by ``1 / size`` on each rank, so that the
    group's sums of the input's and the router pair's gradients count it
    once, as every other contribution there is a rank's own experts'
    share.  ``dp`` (``tensor_parallel.DataGroup``): ``x`` is this rank's
    rows of a batch whose rows the group splits; the aux loss is the
    global batch's (the gradient of each rank's rows its own), or None
    with ``need_aux=False``."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.n_experts_per_tok
    T = B * S
    cap = capacity(T * (1 if dp is None else dp.size), k, E,
                   cfg.moe_capacity_factor)

    xf = x.reshape(T, d)
    # the fp32 router cast to x's dtype, the product in fp32
    logits = matmul(xf, params["router"].to(x.dtype), out_dtype=torch.float32)
    delta = _router_delta(adapters, x, adapter_ids)
    if delta is not None:
        logits = logits + lora_scale * delta.reshape(T, E)
    weights, ids, aux = _top_k_routing(logits, k)

    if dp is None:
        dest, keep = dispatch(ids, E, cap)
    else:   # every rank's ids in flat order: the reference's dispatch
        every = dp.gather(ids.to(torch.int32).contiguous()).long()
        dest, keep = dispatch(every, E, cap)
        own = slice(dp.rank * T * k, (dp.rank + 1) * T * k)
        dest, keep = dest[own], keep[own]
        aux = _global_aux(logits, ids, E, T * dp.size, dp) if need_aux \
            else None
    n = E
    if tp is not None:  # this rank's experts: buffer rows [lo, lo + n·cap)
        n = params["w_up"].shape[0]
        lo = tp.rank * n * cap
        keep = keep & (dest >= lo) & (dest < lo + n * cap)
        dest = torch.where(keep, dest - lo, torch.full_like(dest, n * cap))
    token_idx = torch.arange(T, device=x.device).repeat_interleave(k)
    buf = torch.zeros((n * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[dest] = xf[token_idx]         # dropped copies all land in the last row
    buf = buf[:n * cap].reshape(n, cap, d)

    w_up = params["w_up"].to(x.dtype)
    if "w_gate" in params:
        g = _bmm_f32(buf, params["w_gate"].to(x.dtype))
        u = _bmm_f32(buf, w_up)
        act = (F.silu(g) if cfg.mlp_type == "swiglu"
               else F.gelu(g, approximate="tanh"))
        h = (act * u).to(x.dtype)
    else:
        h = F.gelu(_bmm_f32(buf, w_up), approximate="tanh").to(x.dtype)
    y_buf = _bmm_f32(h, params["w_out"].to(x.dtype)).to(x.dtype)

    y_flat = torch.cat([y_buf.reshape(n * cap, d),
                        torch.zeros((1, d), dtype=x.dtype, device=x.device)])
    # every token owns rows t·k .. t·k+k-1: sum its k copies in a fixed
    # order (no atomics), from 0 as the reference's scatter-add does
    y_copies = (y_flat[dest].float()
                * (weights.reshape(-1) * keep.float())[:, None]
                ).reshape(T, k, d)
    out = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    for j in range(k):
        out = out + y_copies[:, j]
    if tp is not None:      # the ranks' experts' partials, summed in fp32
        out = tpl.reduce_from_group(out, tp)
        if aux is not None:
            aux = tpl.grad_scaled(aux, 1.0 / tp.size)
    return out.reshape(B, S, d).to(x.dtype), aux


def _global_aux(logits: torch.Tensor, ids: torch.Tensor, E: int,
                T_global: int, dp) -> torch.Tensor:
    """The Switch aux loss of the whole batch from this rank's rows:
    the rows' counts of first choices and sums of router probabilities,
    one (2, E) fp32 sum over the group, each over the global T (the sum's
    gradient passes whole, so each rank's rows get their own)."""
    probs = torch.softmax(logits.float(), dim=-1)
    sums = torch.stack([F.one_hot(ids[:, 0], E).float().sum(0),
                        probs.sum(0)])
    sums = tpl.reduce_from_group(sums, dp) / T_global
    return torch.sum(sums[0] * sums[1]) * E
