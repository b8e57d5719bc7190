"""Neural-net primitives of the port's models (plain functions on tensors).

Port of the attention, MLP and norm primitives of
``repro/models/layers.py``.  Weights keep the
reference's ``(d_in, d_out)`` layout (``y = x @ w``).  Linear layers take an
optional LoRA pair; the adapter path computes in fp32 and is added to the
frozen base output.  ``cfg.paged_backend`` (resolved by the model before
it gets here) picks the path of every kernel: ``"torch"`` is the plain
version of each (the paged branch gathers the row's blocks and attends one
chunk position at a time, the reference's jnp path, bitwise-stable across
chunk sizes); ``"cuda"`` runs the hand-written kernels: paged decode and
prefill attention, flash attention for the no-cache branch, and the LoRA
kernels for every adapted projection (batched for banks, single-tenant
for a pair, dual for an Eq. 7 pair of pairs).

Every init has a ``*_specs`` function giving its tree of partition specs
(``core/partition.P``) over the mesh axes ``"data"`` and ``"model"``, leaf
for leaf the reference's.  With a model group (``tp``,
``models/tensor_parallel.py``) attention and the MLP run on this rank's
shard of those trees: its heads and ff columns, the row-parallel
``wo``/``w_out`` partials summed over the group.  The reference's
``maybe_shard`` (a sharding constraint on an activation) has no
counterpart: in the port a rank's local rows are its shard, and
collectives are explicit.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.paged_prefill import (_scatter_coords,
                                               paged_prefill_attention,
                                               paged_scatter,
                                               paged_scatter_quant)
from repro_torch.core.partition import P
from repro_torch.models.tensor_parallel import Vocab, reduce_from_group

Params = Dict[str, Any]

# mesh axes of the spec trees; a spec names only these two
MODEL = "model"
DATA = "data"


def matmul(x: torch.Tensor, w: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """x @ w with fp32 accumulation, rounded to ``out_dtype`` (x's dtype by
    default).  An fp32 result from bf16 inputs multiplies in fp32."""
    out_dtype = out_dtype or x.dtype
    if out_dtype == torch.float32 and x.dtype != torch.float32:
        return torch.matmul(x.float(), w.float())
    return torch.matmul(x, w.to(x.dtype)).to(out_dtype)


def lora_delta(x: torch.Tensor, a, b,
               adapter_ids: Optional[torch.Tensor] = None,
               a_scale=None, b_scale=None) -> torch.Tensor:
    """fp32 LoRA update (x·A)·B.  Single-tenant: a (d_in, r), b (r, d_out).
    Banked: a (C, d_in, r), b (C, r, d_out) with ``adapter_ids`` (B,)
    routing each batch row of x (B, S, d_in) to its client; int8 banks pass
    ``a_scale``/``b_scale`` (C,), dequantized after the gather.

    Ragged banks (``AdapterRegistry(ranks=[...])``) arrive as per-bucket
    LISTS: rows route to the bucket holding their global slot, each bucket
    at its own rank, as in the reference."""
    if isinstance(a, (list, tuple)):
        if adapter_ids is None:
            raise ValueError("banked LoRA leaves need adapter_ids")
        out, off = None, 0
        for i, (ab, bb) in enumerate(zip(a, b)):
            cb = ab.shape[0]
            local = torch.clamp(adapter_ids - off, 0, cb - 1)
            d = lora_delta(x, ab, bb, local,
                           a_scale[i] if a_scale is not None else None,
                           b_scale[i] if b_scale is not None else None)
            in_bucket = (adapter_ids >= off) & (adapter_ids < off + cb)
            mask = in_bucket.reshape((-1,) + (1,) * (d.dim() - 1))
            out = d if out is None else torch.where(mask, d, out)
            off += cb
        return out
    xf = x.float()
    if a.dim() == 3:
        if adapter_ids is None:
            raise ValueError("banked LoRA leaves need adapter_ids")
        ids = adapter_ids.long()
        ag, bg = a[ids].float(), b[ids].float()          # (B, d, r), (B, r, n)
        if a_scale is not None:
            ag = ag * a_scale[ids].float()[:, None, None]
            bg = bg * b_scale[ids].float()[:, None, None]
        lead = xf.shape
        z = torch.bmm(xf.reshape(lead[0], -1, lead[-1]), ag)
        return torch.bmm(z, bg).reshape(*lead[:-1], bg.shape[-1])
    af, bf = a.float(), b.float()
    if a_scale is not None:
        af, bf = af * a_scale, bf * b_scale
    return torch.matmul(torch.matmul(xf, af), bf)


class LoRA(NamedTuple):
    """One target's adapter as :func:`dense` takes it: a pair, or a bank
    (stacked or per-bucket lists) with its optional int8 scales and, in the
    registry's kernel view, per-slot ranks for the batched kernel's mask
    (the plain path needs none: padded rank columns hold zeros)."""
    a: Any
    b: Any
    a_scale: Any = None
    b_scale: Any = None
    ranks: Optional[torch.Tensor] = None


class DualPair(NamedTuple):
    """One target's two pairs and their fusion weights (2,) fp32: the
    projection computes the Eq. 7 merge ``(w1·A1 + w2·A2)·(w1·B1 + w2·B2)``
    (``core/dual_lora.dual_tree`` builds such trees)."""
    a1: torch.Tensor
    b1: torch.Tensor
    a2: torch.Tensor
    b2: torch.Tensor
    w: torch.Tensor

    def merged(self) -> LoRA:
        w1, w2 = self.w[0], self.w[1]
        return LoRA(w1 * self.a1 + w2 * self.a2, w1 * self.b1 + w2 * self.b2)


def lora_pair(adapters: Optional[Params], name: str):
    """The :class:`LoRA` (or :class:`DualPair`) :func:`dense` takes for one
    target, or None."""
    if adapters is None or name not in adapters:
        return None
    ad = adapters[name]
    if "a2" in ad:
        return DualPair(ad["a"], ad["b"], ad["a2"], ad["b2"], ad["w"])
    return LoRA(ad["a"], ad["b"], ad.get("a_scale"), ad.get("b_scale"),
                ad.get("ranks"))


def dense(x: torch.Tensor, w: torch.Tensor, lora=None,
          lora_scale: float = 1.0,
          adapter_ids: Optional[torch.Tensor] = None,
          backend: Optional[str] = None) -> torch.Tensor:
    """Linear layer with an optional :class:`LoRA` or :class:`DualPair`.
    With ``backend == "cuda"`` a LoRA kernel computes base and update in
    one pass (rounding once): the batched kernel for a bank (its int8
    scales and rank mask included), the single-tenant kernel for a pair,
    the dual kernel for a :class:`DualPair`.  Otherwise the base product is
    rounded to x's dtype before the fp32 update is added, as in the
    reference."""
    if backend == "cuda" and lora is not None:
        if isinstance(lora, DualPair):
            return kernel_ops.fused_dual_lora_dense(
                x, w, {"a": lora.a1, "b": lora.b1},
                {"a": lora.a2, "b": lora.b2}, lora.w, lora_scale)
        if isinstance(lora.a, (list, tuple)) or lora.a.dim() == 3:
            return kernel_ops.batched_lora_dense(x, w, lora._asdict(),
                                                 adapter_ids, lora_scale)
        if lora.a_scale is not None:
            raise NotImplementedError(
                "paged_backend='cuda' has no kernel for a single int8 "
                "adapter pair; use paged_backend='torch'")
        return kernel_ops.lora_dense(x, w, {"a": lora.a, "b": lora.b},
                                     lora_scale)
    if isinstance(lora, DualPair):
        lora = lora.merged()
    y = matmul(x, w)
    if lora is not None:
        z = lora_delta(x, lora.a, lora.b, adapter_ids, lora.a_scale,
                       lora.b_scale)
        y = (y.float() + lora_scale * z).to(y.dtype)
    return y


def apply_norm(params: Params, x: torch.Tensor, norm_type: str,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if norm_type == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * params["scale"].float()
    else:
        mean = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean((xf - mean) ** 2, dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + eps)
        if norm_type == "layernorm":
            y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, n_heads, hd); positions (B, S) or (S,).  Split-half
    convention: the first and second halves of the head dim rotate as
    pairs."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    angles = positions[..., :, None].float() * freqs          # (..., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Kv, hd) -> (B, S, Kv*n_rep, hd)."""
    if n_rep == 1:
        return x
    return torch.repeat_interleave(x, n_rep, dim=2)


def _attn_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
               sliding_window: int) -> torch.Tensor:
    """Boolean (Sq, Sk) mask, True = attend."""
    causal = k_pos[None, :] <= q_pos[:, None]
    if sliding_window > 0:
        causal = causal & (k_pos[None, :] > (q_pos[:, None] - sliding_window))
    return causal


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg,
          mask: Optional[torch.Tensor], out_dtype) -> torch.Tensor:
    """Masked softmax attention: q (B, Sq, H, hd), k/v (B, Sk, Kv, hd) ->
    (B, Sq, H*hd).  ``mask``: (Sq, Sk) shared, (B, Sq, Sk) per row, or
    None.  Logits and softmax in fp32."""
    B, Sq, H, hd = q.shape
    rep = H // k.shape[2]
    k, v = repeat_kv(k, rep), repeat_kv(v, rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd ** -0.5
    if cfg.attn_logit_softcap > 0:
        c = cfg.attn_logit_softcap
        logits = c * torch.tanh(logits / c)
    if mask is not None:
        shaped = mask[:, None] if mask.dim() == 3 else mask[None, None]
        logits = torch.where(shaped, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(out_dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(out_dtype).reshape(B, Sq, H * hd)


_SCRATCH_PARTS = ("k_pool", "v_pool", "k_scale", "v_scale")


def sync_scratch(kv_cache: Params, block_tables: torch.Tensor,
                 lengths: torch.Tensor, n_new: Optional[torch.Tensor],
                 S: int, dp) -> None:
    """Scratch block 0 of a data rank's pools as the whole batch's serial
    scatter leaves it.  Ragged tails and idle rows write there, each rank
    only its own rows', and the tails' queries read it: their hidden
    states differ from the whole batch's, which an MoE layer routes and
    counts against capacity.  Each rank marks the offsets of block 0
    this dispatch's scatter wrote and one gather over the data group
    (``dp``) gives every rank every rank's block 0, exact in fp32; per
    offset the highest rank that wrote it wins, as the last write in
    (row, position) order wins in the whole batch's scatter (rows follow
    rank order).  In place; on meta tensors the gather is logged only."""
    kp = kv_cache["k_pool"]
    bs = kp.shape[1]
    parts = [n for n in _SCRATCH_PARTS if n in kv_cache]
    wrote = torch.zeros((bs, 1), dtype=torch.float32, device=kp.device)
    if not kp.is_meta:
        blk, off = _scatter_coords(block_tables.shape[0], S, bs,
                                   block_tables, lengths, n_new)
        wrote[off[blk == 0]] = 1.0
    buf = torch.cat([wrote] + [kv_cache[n][0].reshape(bs, -1).float()
                               for n in parts], 1)
    every = dp.gather(buf[None].contiguous())          # (D, bs, width)
    if kp.is_meta:
        return
    rank = torch.arange(1, every.shape[0] + 1, device=kp.device)
    last = (every[:, :, 0] * rank[:, None]).amax(0).long()   # 0: none
    won = every[(last - 1).clamp(min=0), torch.arange(bs, device=kp.device)]
    new = torch.where((last > 0)[:, None], won, buf)
    col = 1
    for n in parts:
        t = kv_cache[n][0]
        w = t[0].numel()
        t.copy_(new[:, col:col + w].reshape(t.shape).to(t.dtype))
        col += w


def _paged_attention_cuda(q, k, v, x, cfg, kv_cache, block_tables,
                          lengths, n_new, out_proj, scratch=None):
    """The paged branch through the CUDA kernels: the chunk's K/V
    scattered into the pools (ragged tails to scratch block 0), then
    decode steps (2-tuple ``paged``, S == 1) attend with exclusive
    ``lengths + 1`` and prefill chunks through the prefill kernel, as
    ``kernels/ops.paged_prefill_gqa_attention`` runs them.  Both kernels
    take ``cfg.sliding_window``.  ``scratch``: a data group whose ranks'
    scratch blocks are synced between the scatter and the kernel
    (:func:`sync_scratch`)."""
    B, S, H, hd = q.shape
    if cfg.attn_logit_softcap > 0:
        raise NotImplementedError(
            "paged_backend='cuda' has no logit softcap in its paged "
            "attention kernels; use paged_backend='torch'")
    kp, vp = kv_cache["k_pool"], kv_cache["v_pool"]
    ks, vs = kv_cache.get("k_scale"), kv_cache.get("v_scale")
    decode = n_new is None and S == 1
    if not decode and n_new is None:
        n_new = torch.full((B,), S, dtype=torch.int32, device=q.device)
    bt = block_tables.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    if ks is not None:
        paged_scatter_quant(kp, vp, ks, vs, k, v, bt, lens, n_new)
    else:
        paged_scatter(kp, vp, k, v, bt, lens, n_new)
    if scratch is not None:
        sync_scratch(kv_cache, block_tables, lengths, n_new, S, scratch)
    if decode:
        o = kernel_ops.paged_gqa_attention(
            q, kp, vp, block_tables, lengths + 1, k_scale=ks, v_scale=vs,
            sliding_window=cfg.sliding_window)
    else:
        o = paged_prefill_attention(
            q.contiguous(), kp, vp, bt, lens, k_scale=ks, v_scale=vs,
            sliding_window=cfg.sliding_window)
    return out_proj(o.to(x.dtype).reshape(B, S, H * hd)), kv_cache


def multihead_attention(params: Params, x: torch.Tensor, cfg,
                        positions: torch.Tensor,
                        adapters: Optional[Params] = None,
                        lora_scale: float = 1.0,
                        kv_cache: Optional[Params] = None,
                        adapter_ids: Optional[torch.Tensor] = None,
                        paged: Optional[Tuple] = None,
                        causal: bool = True,
                        kv_override: Optional[Tuple] = None,
                        tp=None, scratch=None):
    """Attention over x (B, S, d).

    * no cache (training, evaluation): causal (+ window) attention over
      the S positions, through the flash-attention kernel on ``"cuda"``;
      ``causal=False`` attends every key (no mask, no window), as an
      encoder does;
    * cross-attention (the encoder-decoder): ``kv_override=(k, v)``, each
      (B, T, Kv, hd), computed from the encoder's output by the caller;
      ``wk``/``wv`` and their adapters are not read and no RoPE is
      applied, as in the reference; pass ``causal=False``;
    * contiguous decode cache (the fixed-batch path): ``kv_cache`` = {"k",
      "v": (B, S_cache, Kv, hd), "pos": tokens already written (int)}, a
      ring buffer written at ``pos % S_cache`` (full context for dense
      attention, the window for sliding-window archs, so it wraps); each
      slot's absolute position is recovered from the ring.  Attention here
      is the plain path on both backends, as in the reference (jnp outside
      any kernel there); the projections still take ``backend``'s path.
      The cache tensors are updated in place;
    * paged (continuous batching): ``kv_cache`` = {"k_pool", "v_pool":
      (NB, bs, Kv, hd)} shared by all slots (int8 pools add "k_scale",
      "v_scale" (NB, bs, Kv); the scatter quantizes, the reads dequantize),
      ``paged = (block_tables (B, MB), lengths (B,)[, n_new (B,)])``.  The
      S new tokens scatter to positions ``lengths[b] + t`` (with n_new,
      tails go to scratch block 0) and query t attends ``[0, lengths[b] +
      t]``.  The pools are updated in place.

    With ``tp`` the params and adapters are this rank's shards: its
    ``n_heads / size`` query and ``n_kv_heads / size`` kv heads, and
    ``wo``'s partial summed over the group.  A cache then holds the
    rank's kv heads only (``kv_cache_specs``, ``paged_kv_cache_specs``:
    heads on "model"; an int8 pool's scales on the same heads), and every
    branch attends them with the rank's query heads.  ``scratch`` (a data
    group; paged only): the rows are a data rank's, and the pools'
    scratch block is synced over the group after each scatter
    (:func:`sync_scratch`).

    Returns (out (B, S, d), new cache or None)."""
    H, Kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    if tp is not None:
        H, Kv = H // tp.size, Kv // tp.size
    B, S, _ = x.shape
    backend = cfg.paged_backend

    def la(name):
        return lora_pair(adapters, name)

    def dn(inp, w, lora):
        return dense(inp, w, lora, lora_scale, adapter_ids, backend)

    def out_proj(o):
        """``wo`` (row-parallel under ``tp``: the partials summed)."""
        out = dn(o, params["wo"], la("wo"))
        return out if tp is None else reduce_from_group(out, tp)

    q = dn(x, params["wq"], la("wq")).reshape(B, S, H, hd)
    if kv_override is None:
        k = dn(x, params["wk"], la("wk")).reshape(B, S, Kv, hd)
        v = dn(x, params["wv"], la("wv")).reshape(B, S, Kv, hd)
        if cfg.use_rope:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
    else:
        k, v = kv_override

    if kv_cache is None:
        if backend == "cuda":
            if cfg.attn_logit_softcap > 0:
                raise NotImplementedError(
                    "paged_backend='cuda' has no logit softcap in its flash "
                    "attention kernel; use paged_backend='torch'")
            out = kernel_ops.gqa_flash_attention(
                q, k, v, causal=causal,
                sliding_window=cfg.sliding_window if causal else 0)
            out = out.reshape(B, S, H * hd)
        else:
            mask = (_attn_mask(positions, positions, cfg.sliding_window)
                    if causal else None)
            out = _sdpa(q, k, v, cfg, mask, x.dtype)
        return out_proj(out), None

    if paged is None:
        return _ring_attention(q, k, v, x, cfg, kv_cache, positions,
                               out_proj)
    if len(paged) == 3:
        block_tables, lengths, n_new = paged
    else:
        (block_tables, lengths), n_new = paged, None
    if backend == "cuda":
        return _paged_attention_cuda(q, k, v, x, cfg, kv_cache,
                                     block_tables, lengths, n_new, out_proj,
                                     scratch)
    kp, vp = kv_cache["k_pool"], kv_cache["v_pool"]
    bs_blk = kp.shape[1]
    pos = (lengths.long()[:, None]
           + torch.arange(S, device=x.device)[None, :])    # write positions
    L = block_tables.shape[1] * bs_blk
    bt = block_tables.long()
    if "k_scale" in kv_cache:                 # int8 pools: dequant the gather
        ks, vs = kv_cache["k_scale"], kv_cache["v_scale"]
        paged_scatter_quant(kp, vp, ks, vs, k, v, block_tables, lengths,
                            n_new)
        if scratch is not None:
            sync_scratch(kv_cache, block_tables, lengths, n_new, S, scratch)
        # the reference's order: fp32 values times fp32 scales, then one
        # cast to the working type
        kg = (kp[bt].reshape(B, L, Kv, hd).float()
              * ks[bt].reshape(B, L, Kv)[..., None]).to(x.dtype)
        vg = (vp[bt].reshape(B, L, Kv, hd).float()
              * vs[bt].reshape(B, L, Kv)[..., None]).to(x.dtype)
    else:
        paged_scatter(kp, vp, k, v, block_tables, lengths, n_new)
        if scratch is not None:
            sync_scratch(kv_cache, block_tables, lengths, n_new, S, scratch)
        kg = kp[bt].reshape(B, L, Kv, hd).to(x.dtype)
        vg = vp[bt].reshape(B, L, Kv, hd).to(x.dtype)
    k_pos = torch.arange(L, device=x.device)
    # one attend per chunk position with the exact decode-step shapes, so a
    # T-token chunk is bitwise-equal to T decode steps
    outs = [_sdpa(q[:, t:t + 1], kg, vg, cfg,
                  _attn_mask(pos[:, t], k_pos, cfg.sliding_window)[:, None, :],
                  x.dtype)
            for t in range(S)]
    out = outs[0] if S == 1 else torch.cat(outs, dim=1)
    return out_proj(out), kv_cache


def _ring_attention(q, k, v, x, cfg, kv_cache, positions, out_proj):
    """Attention over the contiguous ring-buffer cache: write the S new
    K/V at slots ``(pos + t) % S_cache``, then attend every slot whose
    recovered absolute position is causal (and inside the window) for the
    query; never-written slots (negative position) are masked."""
    S = q.shape[1]
    ck, cv = kv_cache["k"], kv_cache["v"]
    cache_len = ck.shape[1]
    pos = kv_cache["pos"]
    slots = torch.arange(pos, pos + S, device=x.device) % cache_len
    ck.index_copy_(1, slots, k.to(ck.dtype))
    cv.index_copy_(1, slots, v.to(cv.dtype))
    n = pos + S                                   # tokens written after this
    slot = torch.arange(cache_len, device=x.device)
    # largest p <= n - 1 with p % cache_len == slot (negative: not written)
    k_pos = slot + torch.div(n - 1 - slot, cache_len,
                             rounding_mode="floor") * cache_len
    mask = (_attn_mask(positions, k_pos, cfg.sliding_window)
            & (k_pos >= 0)[None, :])
    out = _sdpa(q, ck.to(x.dtype), cv.to(x.dtype), cfg, mask, x.dtype)
    return out_proj(out), {"k": ck, "v": cv, "pos": n}


def norm_specs(norm_type: str) -> Params:
    if norm_type == "rmsnorm":
        return {"scale": P(None)}
    if norm_type == "layernorm":
        return {"scale": P(None), "bias": P(None)}
    return {}


def attention_specs(cfg) -> Params:
    """The projections' head (output) dim on the model axis, ``wo`` on its
    input (head) dim; d_model replicated."""
    return {"wq": P(None, MODEL), "wk": P(None, MODEL),
            "wv": P(None, MODEL), "wo": P(MODEL, None)}


def mlp_specs(mlp_type: str) -> Params:
    p = {"w_up": P(None, MODEL), "w_out": P(MODEL, None)}
    if mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = P(None, MODEL)
    return p


def embed_specs(vocab_size: int) -> P:
    """The vocabulary on the model axis, split where the axis divides it
    and whole on every rank where it does not (``tensor_parallel.Vocab``,
    ``vocab_split``)."""
    return P(Vocab(MODEL, vocab_size), None)


def lm_head_specs(vocab_size: int) -> P:
    """An untied head's (d, V): its vocabulary as :func:`embed_specs`'."""
    return P(None, Vocab(MODEL, vocab_size))


def kv_cache_specs() -> Params:
    """Ring buffers: rows on the data axis, kv heads on the model axis;
    the write count replicated."""
    return {"k": P(DATA, None, MODEL, None), "v": P(DATA, None, MODEL, None),
            "pos": P()}


def paged_kv_cache_specs(kv_dtype: str = "f32") -> Params:
    """The block pools are shared by every slot (no row axis to split);
    kv heads on the model axis."""
    specs = {"k_pool": P(None, None, MODEL, None),
             "v_pool": P(None, None, MODEL, None)}
    if kv_dtype == "int8":
        specs["k_scale"] = P(None, None, MODEL)
        specs["v_scale"] = P(None, None, MODEL)
    return specs


def _kv_heads(cfg, tp) -> int:
    return cfg.n_kv_heads if tp is None else cfg.n_kv_heads // tp.size


def init_kv_cache(cfg, batch: int, cache_len: int, dtype, device,
                  tp=None) -> Params:
    """One layer's contiguous decode cache (the fixed-batch path); with
    ``tp`` the rank's ``n_kv_heads / size`` kv heads."""
    shape = (batch, cache_len, _kv_heads(cfg, tp), cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device), "pos": 0}


def init_paged_kv_cache(cfg, num_blocks: int, block_size: int, dtype,
                        device, kv_dtype: str = "f32", tp=None) -> Params:
    """One K/V pool per layer, shared by every serving slot.  ``"int8"``
    stores the pools as int8 with one fp32 scale per (block, position,
    kv-head) in ``k_scale``/``v_scale`` (NB, bs, Kv) leaves; ``"f32"`` keeps
    unquantized pools in ``dtype``.  With ``tp`` the pools (and scales)
    hold the rank's ``n_kv_heads / size`` kv heads."""
    shape = (num_blocks, block_size, _kv_heads(cfg, tp),
             cfg.resolved_head_dim)
    if kv_dtype == "int8":
        return {"k_pool": torch.zeros(shape, dtype=torch.int8, device=device),
                "v_pool": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3], device=device),
                "v_scale": torch.zeros(shape[:3], device=device)}
    if kv_dtype != "f32":
        raise ValueError(f"kv_dtype must be 'f32' or 'int8', got {kv_dtype!r}")
    return {"k_pool": torch.zeros(shape, dtype=dtype, device=device),
            "v_pool": torch.zeros(shape, dtype=dtype, device=device)}


def apply_mlp(params: Params, x: torch.Tensor, mlp_type: str,
              adapters: Optional[Params] = None, lora_scale: float = 1.0,
              adapter_ids: Optional[torch.Tensor] = None,
              backend: Optional[str] = None, tp=None) -> torch.Tensor:
    """The dense MLP; with ``tp`` on this rank's ff columns, ``w_out``'s
    partial summed over the group."""
    def dn(inp, name):
        return dense(inp, params[name], lora_pair(adapters, name),
                     lora_scale, adapter_ids, backend)

    if mlp_type in ("swiglu", "geglu"):
        g = dn(x, "w_gate")
        u = dn(x, "w_up")
        act = (F.silu(g.float()) if mlp_type == "swiglu"
               else F.gelu(g.float(), approximate="tanh"))
        h = act.to(x.dtype) * u
    else:
        h = F.gelu(dn(x, "w_up").float(), approximate="tanh").to(x.dtype)
    out = dn(h, "w_out")
    return out if tp is None else reduce_from_group(out, tp)

