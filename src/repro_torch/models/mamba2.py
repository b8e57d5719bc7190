"""Mamba2 (SSD, state-space duality, arXiv:2405.21060) block.

Port of ``repro/models/mamba2.py``.  One ``in_proj`` gives (z, x, B, C,
dt); a depthwise causal conv runs over (x, B, C); the decay A is a scalar
per head; a gated RMSNorm comes before ``out_proj``.  Both projections
take their LoRA pair (or bank) through ``layers.dense``, so on ``"cuda"``
they run the LoRA kernels; everything else is plain torch on both
backends, as the reference computes it in plain jnp:

* no cache (training, evaluation): the chunked SSD scan in matmul form
  (:func:`ssd_chunked`);
* with a cache (serving): the recurrence ``h' = h·exp(dt·A) + dt·x·Bᵀ``,
  ``y = h·C``, one token at a time (:func:`ssm_recurrence`).  A chunk of S
  tokens steps through the same per-token ops on operands of the same
  shapes, so on one device it equals S one-token calls bitwise; tokens
  past a row's ``n_new`` carry dt = 0 (decay 1, update 0) and leave its
  state as it was.

Decode state per row: ``h`` (H, P, N) fp32 and ``conv`` (K-1, conv_dim),
the last K-1 conv inputs, in the activations' dtype once a step has run
(the cache starts in bf16, as the reference's does).

Over a ``"model"`` group (``tp``, ``models/tensor_parallel.py``) a rank
runs its ``H / size`` heads: its columns of every segment of ``in_proj``
(``[z | x | B | C | dt]``) and of the conv (``[x | B | C]``), ``B`` and
``C`` whole where ``ssm_n_groups`` is 1 (``tensor_parallel.Segments``,
:func:`in_proj_segments`), its heads' rows of ``out_proj`` (row-parallel)
and its slice of the per-head ``a_log``, ``dt_bias`` and ``d_skip``,
which every rank holds whole.  The gated norm's mean of squares over
``d_inner`` is one fp32 sum over the group.  Its decode state is its
heads of ``h`` and its ``[x | B | C]`` conv columns.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.partition import P
from repro_torch.models import tensor_parallel as tpl
from repro_torch.models.layers import DATA, MODEL, dense, lora_pair

Params = Dict[str, Any]


def _dims(cfg, size: int = 1):
    """(d_inner, heads, d_state, groups, conv columns, in_proj columns)
    of one rank of a ``size``-way model axis: heads and ``d_inner`` its
    share, the groups too where they divide (at 1 group, the whole)."""
    d_in = cfg.ssm_d_inner // size
    n_h = cfg.ssm_n_heads // size
    d_st = cfg.ssm_d_state
    n_g = cfg.ssm_n_groups
    if n_g % size == 0:
        n_g //= size
    conv_dim = d_in + 2 * n_g * d_st
    proj_dim = 2 * d_in + 2 * n_g * d_st + n_h
    return d_in, n_h, d_st, n_g, conv_dim, proj_dim


def conv_segments(cfg):
    """The conv's (and the conv state's) columns ``[x | B | C]`` as
    ``tensor_parallel.Segments`` takes them: (width, heads or groups)."""
    d_in, n_h, d_st, n_g, _, _ = _dims(cfg)
    return ((d_in, n_h), (n_g * d_st, n_g), (n_g * d_st, n_g))


def in_proj_segments(cfg):
    """``in_proj``'s columns ``[z | x | B | C | dt]`` (its LoRA B's too)
    as ``tensor_parallel.Segments`` takes them."""
    d_in, n_h, _, _, _, _ = _dims(cfg)
    return ((d_in, n_h),) + conv_segments(cfg) + ((n_h, n_h),)


def init_mamba(normal, cfg, device) -> Params:
    """One mamba layer's weights with the reference's scales:
    ``normal(shape, std, out_dtype=None)`` draws the projections (normal ×
    d^-0.5 for ``in_proj``, × d_inner^-0.5 for ``out_proj``) and the conv
    (× 0.1) in the parameter dtype; ``a_log``, ``dt_bias``, ``d_skip`` and
    ``norm_scale`` are fp32 whatever the parameter dtype."""
    d = cfg.d_model
    d_in, n_h, _, _, conv_dim, proj_dim = _dims(cfg)
    f32 = torch.float32
    return {
        "in_proj": normal((d, proj_dim), d ** -0.5),
        "conv_w": normal((cfg.ssm_d_conv, conv_dim), 0.1),
        "a_log": torch.log(torch.linspace(1.0, 16.0, n_h, dtype=f32,
                                          device=device)),
        "dt_bias": torch.zeros(n_h, dtype=f32, device=device),
        "d_skip": torch.ones(n_h, dtype=f32, device=device),
        "norm_scale": torch.ones(d_in, dtype=f32, device=device),
        "out_proj": normal((d_in, d), d_in ** -0.5),
    }


def mamba_specs(cfg) -> Params:
    """The reference's specs (``in_proj`` and conv columns, the norm's
    scale and ``out_proj``'s rows on ``"model"``), the segmented columns
    cut by heads within each segment (``tensor_parallel.Segments``)."""
    return {
        "in_proj": P(None, tpl.Segments(MODEL, in_proj_segments(cfg))),
        "conv_w": P(None, tpl.Segments(MODEL, conv_segments(cfg))),
        "a_log": P(None),
        "dt_bias": P(None),
        "d_skip": P(None),
        "norm_scale": P(MODEL),
        "out_proj": P(MODEL, None),
    }


def _split_proj(cfg, zxbcdt, size: int = 1):
    d_in, n_h, d_st, n_g, _, _ = _dims(cfg, size)
    return torch.split(zxbcdt, [d_in, d_in + 2 * n_g * d_st, n_h], dim=-1)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None,
                 n_valid: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d, xbc (B, S, C), w (K, C).  Returns (silu of
    the conv in xbc's dtype, the new state: the last K-1 inputs (B, K-1,
    C)).  No ``state``: zero left padding.  ``n_valid`` (B,) counts each
    row's valid leading tokens: the new state is the K-1 inputs ending at
    the row's fill, so a row fed only padding keeps its state."""
    K = w.shape[0]
    if state is None:
        pad = xbc.new_zeros((xbc.shape[0], K - 1, xbc.shape[2]))
        xp = torch.cat([pad, xbc], dim=1)
        new_state = xp[:, -(K - 1):, :].contiguous()
    else:
        xp = torch.cat([state.to(xbc.dtype), xbc], dim=1)
        if n_valid is None:
            new_state = xp[:, -(K - 1):, :].contiguous()
        else:
            idx = (n_valid.long()[:, None]
                   + torch.arange(K - 1, device=xbc.device)[None])
            new_state = torch.gather(
                xp, 1, idx[:, :, None].expand(-1, -1, xp.shape[2]))
    # windowed sum: out[t] = sum_k w[k] * xp[t + k], in fp32
    S = xbc.shape[1]
    xpf, wf = xp.float(), w.float()
    out = xpf[:, :S] * wf[0]
    for k in range(1, K):
        out = out + xpf[:, k:k + S] * wf[k]
    return F.silu(out).to(xbc.dtype), new_state


def _gated_norm(x, z, scale, eps: float = 1e-6, tp=None,
                d_inner: int = 0):
    """RMSNorm of ``x · silu(z)`` over ``d_inner``; with ``tp`` each rank
    holds its columns, and the sum of squares is summed over the group
    (its gradient too) before the division by the global ``d_inner``."""
    xf = x.float() * F.silu(z.float())
    if tp is None:
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
    else:
        var = tpl.sum_over_group(torch.sum(xf * xf, dim=-1, keepdim=True),
                                 tp) / d_inner
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """Chunked SSD scan (matmul form).

    x (B, S, H, P) inputs per head; dt (B, S, H) softplus'd timesteps;
    A (H,) negative decay rates; Bm, Cm (B, S, G, N) the input->state and
    state->output projections.  Returns (y (B, S, H, P), final state (B,
    H, P, N)), fp32."""
    Bsz, S, H, Pd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    assert S % chunk == 0, (S, chunk)
    nc = S // chunk
    rep = H // G

    x, dt = x.float(), dt.float()
    Bm = torch.repeat_interleave(Bm.float(), rep, dim=2)     # (B,S,H,N)
    Cm = torch.repeat_interleave(Cm.float(), rep, dim=2)

    def reshape_c(t):
        return t.reshape((Bsz, nc, chunk) + tuple(t.shape[2:]))

    xc, dtc, Bc, Cc = map(reshape_c, (x, dt, Bm, Cm))

    # per-step log decay a_t = A * dt_t (A < 0), running within the chunk
    cum = torch.cumsum(dtc * A[None, None, None, :], dim=2)  # (B,nc,c,H)
    # intra-chunk: y[t] = sum_{s<=t} C_t.B_s x_s dt_s exp(cum_t - cum_s).
    # Mask BEFORE the exp: for s > t the exponent is large and positive, exp
    # overflows to inf and the masked backward gives 0·inf = NaN.
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,nc,t,s,H)
    idx = torch.arange(chunk, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    decay = torch.exp(torch.where(causal, diff,
                                  torch.full_like(diff, -1e30)))
    cb = torch.einsum("bzthn,bzshn->bztsh", Cc, Bc)
    xdt = xc * dtc[..., None]                                 # (B,nc,c,H,P)
    y_intra = torch.einsum("bztsh,bzshp->bzthp", cb * decay, xdt)

    # chunk states: state_z = sum_s exp(cum_end - cum_s) B_s x_s dt_s
    seg = torch.exp(cum[:, :, -1:, :] - cum)                  # (B,nc,c,H)
    states = torch.einsum("bzsh,bzshn,bzshp->bzhpn", seg, Bc, xdt)
    chunk_decay = torch.exp(cum[:, :, -1, :])                 # (B,nc,H)

    # inter-chunk recurrence over the nc chunks
    h = x.new_zeros((Bsz, H, Pd, N))
    h_prevs = []
    for z in range(nc):
        h_prevs.append(h)                                     # entering z
        h = h * chunk_decay[:, z, :, None, None] + states[:, z]
    h_prev = torch.stack(h_prevs, dim=1)                      # (B,nc,H,P,N)

    into = torch.exp(cum)                 # decay from the chunk start to t
    y_inter = torch.einsum("bzth,bzthn,bzhpn->bzthp", into, Cc, h_prev)
    y = (y_intra + y_inter).reshape(Bsz, S, H, Pd)
    return y, h


def ssm_recurrence(h, xs, dt, A, Bm, Cm):
    """The recurrence over S tokens from state ``h`` (B, H, P, N): xs (B,
    S, H, P), dt (B, S, H) (0 where a token must not move the state), A
    (H,), Bm and Cm (B, S, G, N).  Returns (y (B, S, H, P), h) fp32.

    What does not depend on h is computed for the whole chunk first, in
    token-major (S, B·H, ...) layout, so that each token's operands are
    contiguous slices of one shape and layout whatever S is: a token then
    takes the same code path in every kernel, and a chunk equals S
    one-token calls bitwise.  The exp of dt·A stays in the loop: an
    elementwise kernel may take another path for an element depending on
    where it sits in the tensor.  A token is 4 launches on a state updated
    in place: exp, the decay, the update, the output."""
    Bsz, S, H, P = xs.shape
    N = Bm.shape[-1]
    rep = H // Bm.shape[2]

    def tok_major(t):
        return t.float().transpose(0, 1).contiguous()

    dt_t = tok_major(dt)                                      # (S, B, H)
    dA = (dt_t * A).reshape(S, Bsz * H, 1, 1)
    dtx = (dt_t[..., None] * tok_major(xs)).reshape(S, Bsz * H, P, 1)
    Bh = torch.repeat_interleave(tok_major(Bm), rep, dim=2).reshape(
        S, Bsz * H, 1, N)
    Ch = torch.repeat_interleave(tok_major(Cm), rep, dim=2).reshape(
        S, Bsz * H, N, 1)
    h = h.float().reshape(Bsz * H, P, N).clone()
    ys = []
    for dA_t, dtx_t, b_t, c_t in zip(dA.unbind(0), dtx.unbind(0),
                                     Bh.unbind(0), Ch.unbind(0)):
        # h' = h·exp(dt·A) + dt·x·Bᵀ;  y = h'·C
        h.mul_(torch.exp(dA_t)).addcmul_(dtx_t, b_t)
        ys.append(torch.bmm(h, c_t))
    y = torch.stack(ys).reshape(S, Bsz, H, P).transpose(0, 1)
    return y, h.reshape(Bsz, H, P, N)


def apply_mamba(params: Params, x: torch.Tensor, cfg,
                adapters: Optional[Params] = None, lora_scale: float = 1.0,
                ssm_cache: Optional[Params] = None,
                adapter_ids: Optional[torch.Tensor] = None,
                n_new: Optional[torch.Tensor] = None, tp=None):
    """x (B, S, d) -> (out, new cache).

    ``ssm_cache`` = {"h": (B, H, P, N), "conv": (B, K-1, conv_dim)} for
    decode, S >= 1 (a prefill chunk steps the recurrence token by token).
    ``n_new`` (B,) int32 marks each row's valid leading tokens (ragged
    chunks): tokens past a row's fill get dt = 0, so its recurrent and
    conv state pass through untouched.  Without a cache the SSD chunked
    form runs (training) and the new cache is its final state.

    ``tp`` (``tensor_parallel.ModelGroup``): params, adapters and cache
    are this rank's shards (``mamba_specs``, ``core/lora.adapter_specs``,
    :func:`init_ssm_cache`), ``x`` already through ``copy_to_group``; the
    rank runs its ``H / size`` heads, the scan and recurrence unchanged
    on them (a local head's group is its global head's, since the rank's
    heads and groups are blocks of the same order), and ``out`` is the
    group's sum."""
    B, S, _ = x.shape
    size = 1 if tp is None else tp.size
    d_in, n_h, d_st, n_g, _, _ = _dims(cfg, size)
    first = 0 if tp is None else tp.rank * n_h

    def heads(name):    # per-head leaves every rank holds whole
        return params[name][first:first + n_h]

    def dn(inp, name):
        return dense(inp, params[name], lora_pair(adapters, name),
                     lora_scale, adapter_ids, cfg.paged_backend)

    z, xbc, dt_raw = _split_proj(cfg, dn(x, "in_proj"), size)
    dt = F.softplus(dt_raw.float() + heads("dt_bias"))

    conv_state = ssm_cache["conv"] if ssm_cache is not None else None
    xbc, new_conv = _causal_conv(
        xbc, params["conv_w"], conv_state,
        n_valid=n_new if ssm_cache is not None else None)
    xs, Bm, Cm = torch.split(xbc, [d_in, n_g * d_st, n_g * d_st], dim=-1)
    xs = xs.reshape(B, S, n_h, cfg.ssm_head_dim)
    Bm = Bm.reshape(B, S, n_g, d_st)
    Cm = Cm.reshape(B, S, n_g, d_st)
    A = -torch.exp(heads("a_log").float())                   # (H,) negative

    if ssm_cache is None:
        y, h = ssd_chunked(xs, dt, A, Bm, Cm, min(cfg.ssm_chunk, S))
    else:
        if n_new is not None:
            valid = (torch.arange(S, device=x.device)[None, :]
                     < n_new.to(x.device)[:, None])
            dt = torch.where(valid[:, :, None], dt, torch.zeros_like(dt))
        y, h = ssm_recurrence(ssm_cache["h"], xs, dt, A, Bm, Cm)

    y = y + xs.float() * heads("d_skip")[None, None, :, None]
    y = y.reshape(B, S, d_in).to(x.dtype)
    y = _gated_norm(y, z, params["norm_scale"], tp=tp,
                    d_inner=cfg.ssm_d_inner)
    out = dn(y, "out_proj")
    if tp is not None:
        out = tpl.reduce_from_group(out, tp)
    return out, {"h": h.float(), "conv": new_conv}


def init_ssm_cache(cfg, batch: int, device, tp=None) -> Params:
    """Zero decode state for ``batch`` rows: ``h`` fp32, ``conv`` bf16 (it
    takes the activations' dtype at the first step, as in the
    reference).  With ``tp`` the rank's heads of ``h`` and its ``[x | B
    | C]`` conv columns (:func:`ssm_cache_specs`)."""
    _, n_h, d_st, _, conv_dim, _ = _dims(cfg, 1 if tp is None else tp.size)
    return {"h": torch.zeros((batch, n_h, cfg.ssm_head_dim, d_st),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.ssm_d_conv - 1, conv_dim),
                                dtype=torch.bfloat16, device=device)}


def ssm_cache_specs(cfg) -> Params:
    """Slots on "data"; heads of ``h`` and the conv state's ``[x | B |
    C]`` columns, cut by heads within each segment, on "model"."""
    return {"h": P(DATA, MODEL, None, None),
            "conv": P(DATA, None, tpl.Segments(MODEL, conv_segments(cfg)))}
