"""The bf16 tolerance of the port's tensor-core attention tile, on the CPU.

The tile (``src/repro_torch/kernels/csrc/attn_mma.cuh``) rounds the
unnormalised probabilities P, or ``P·v_scale`` for int8 pools, to bf16 as
the operand of its P·V product, as the TPU kernels do for bf16 values; the
plain versions keep P in fp32 (or round it after normalising).  Each output
is a convex sum of rows of V, so that one rounding moves it by at most
``2^-8·max|v|``.  The card checks therefore hold bf16 queries to two bf16
roundings of the largest output plus that term.

Here the tile's arithmetic is emulated in torch one CTA at a time (64-key
tiles, exp2 with log2(e) folded into the scale, a running max, bf16 P,
fp32 accumulators, one rounding of the output) and held to that bound
against the plain versions at small shapes, for bf16 and int8 pools; the
Pallas prefill kernel in interpret mode, which rounds P the same way, is
held to it too.

The card checks also hold every row of the tile's output to two bf16 ulps
of the tile references in ``repro_torch/kernels/attn_tile.py``, which
batch the heads of a CTA's tiles; here those references are held to the
per-CTA emulation, with and without a sliding window and at head dim 256
to the reference package's oracle, and to the pool slots the kernel never
reads.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as j_ref
from repro.kernels.paged_prefill import \
    paged_prefill_attention as j_paged_prefill
from repro_torch.kernels import attn_tile, ref
from repro_torch.kernels.quant import quantize_int8

KEYS = 64       # keys per tile
ROWS = 64       # query rows per CTA


def attn_tol(ref_out, v) -> float:
    """The card checks' bound: two bf16 roundings of the largest output,
    plus one bf16 rounding of the largest |v| (dequantized)."""
    return (float(ref_out.float().abs().max()) * 2.0 ** -7 + 1e-5
            + float(v.float().abs().max()) * 2.0 ** -8)


def emulate_tile(q, k, v, lo, hi, scale, k_begin, k_end, ks=None, vs=None):
    """The tile's arithmetic for one CTA: q (R, d) bf16 values, k / v (L, d)
    (bf16 values, or int8 values with per-key fp32 scales ``ks`` / ``vs``),
    row r attending keys lo[r] <= j <= hi[r] in [k_begin, k_end).  Returns
    (R, d) fp32, before the output's bf16 rounding."""
    R, d = q.shape
    m = torch.full((R,), -math.inf)
    den = torch.zeros(R)
    acc = torch.zeros(R, d)
    sl2 = scale * math.log2(math.e)
    for k0 in range(k_begin, k_end, KEYS):
        j = torch.arange(k0, min(k0 + KEYS, k_end))
        s = (q.float() @ k[j].float().T) * sl2
        if ks is not None:
            s = s * ks[j][None, :]
        on = (j[None, :] >= lo[:, None]) & (j[None, :] <= hi[:, None])
        s = torch.where(on, s, torch.tensor(-math.inf))
        mx = torch.maximum(m, s.max(dim=1).values)
        mu = torch.where(torch.isinf(mx), torch.zeros_like(mx), mx)
        alpha = torch.exp2(m - mu)
        p = torch.exp2(s - mu[:, None])
        den = den * alpha + p.sum(dim=1)
        if vs is not None:
            p = p * vs[j][None, :]
        acc = acc * alpha[:, None] + p.to(torch.bfloat16).float() @ v[j].float()
        m = mx
    return acc / torch.where(den > 0, den, torch.ones_like(den))[:, None]


def emulate_prefill(q, k_pool, v_pool, block_tables, lengths, k_scale=None,
                    v_scale=None, window=0):
    """``paged_prefill_attention`` through the emulated tile: per (row, kv
    head) the folded rows f = t·G + g in CTAs of 64, keys gathered through
    the table from the CTA's first query's window start (0 without a
    window) up to its last query (and the table's end)."""
    B, T, H, hd = q.shape
    bs, Kv = k_pool.shape[1], k_pool.shape[2]
    G = H // Kv
    MB = block_tables.shape[1]
    scale = hd ** -0.5
    out = torch.zeros(B, T, H, hd)
    for b in range(B):
        blocks = block_tables[b].long()
        base = int(lengths[b])
        for kv in range(Kv):
            k = k_pool[blocks, :, kv].reshape(MB * bs, hd)
            v = v_pool[blocks, :, kv].reshape(MB * bs, hd)
            ks = vs = None
            if k_scale is not None:
                ks = k_scale[blocks, :, kv].reshape(MB * bs)
                vs = v_scale[blocks, :, kv].reshape(MB * bs)
            for f0 in range(0, T * G, ROWS):
                f = torch.arange(f0, min(f0 + ROWS, T * G))
                t, g = f // G, f % G
                k_end = min(base + int(t[-1]) + 1, MB * bs)
                hi = torch.clamp(base + t, max=k_end - 1)
                lo = torch.zeros_like(hi)
                k_begin = 0
                if window > 0:
                    lo = torch.clamp(base + t - window + 1, min=0)
                    k_begin = int(lo[0])
                o = emulate_tile(q[b, t, kv * G + g], k, v, lo, hi, scale,
                                 k_begin, k_end, ks, vs)
                out[b, t, kv * G + g] = o
    return out.to(q.dtype)


def emulate_flash(q, k, v, causal=True, window=0):
    """``flash_attention`` through the emulated tile: CTAs of 64 query rows,
    keys from the window's start to the causal limit of the last row."""
    B, H, Sq, d = q.shape
    Kv, Sk = k.shape[1], k.shape[2]
    G = H // Kv
    off = Sk - Sq
    out = torch.zeros(B, H, Sq, d)
    for b in range(B):
        for h in range(H):
            for i0 in range(0, Sq, ROWS):
                i = torch.arange(i0, min(i0 + ROWS, Sq))
                qp = off + i
                kv_lo = max(0, int(qp[0]) - window + 1) if window > 0 else 0
                kv_hi = min(Sk - 1, int(qp[-1])) if causal else Sk - 1
                hi = torch.clamp(qp, max=kv_hi) if causal else \
                    torch.full_like(qp, kv_hi)
                lo = torch.clamp(qp - window + 1, min=0) if window > 0 else \
                    torch.zeros_like(qp)
                out[b, h, i] = emulate_tile(q[b, h, i], k[b, h // G],
                                            v[b, h // G], lo, hi, d ** -0.5,
                                            kv_lo, kv_hi + 1)
    return out.to(q.dtype)


def _prefill_inputs(seed, B, T, H, Kv, hd, bs, lengths, int8):
    rng = np.random.default_rng(seed)
    MB = -(-(max(lengths) + T) // bs)
    NB = 1 + B * MB
    kf = torch.from_numpy(rng.standard_normal((NB, bs, Kv, hd))
                          .astype(np.float32))
    vf = torch.from_numpy(rng.standard_normal((NB, bs, Kv, hd))
                          .astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((B, T, H, hd))
                         .astype(np.float32)).to(torch.bfloat16)
    bt = torch.from_numpy(np.stack([rng.permutation(np.arange(1, NB))[:MB]
                                    for _ in range(B)]).astype(np.int32))
    lens = torch.tensor(lengths, dtype=torch.int32)
    if int8:
        kp, ks = quantize_int8(kf, -1)
        vp, vs = quantize_int8(vf, -1)
        return q, kp, vp, bt, lens, {"k_scale": ks, "v_scale": vs}, \
            vp.float() * vs[..., None]
    kp, vp = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
    return q, kp, vp, bt, lens, {}, vp


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("T,H,Kv,bs", [(70, 2, 2, 16), (40, 4, 2, 8)])
def test_prefill_tile_rounding_within_the_bound(T, H, Kv, bs, int8):
    """Folded rows past a 64-row edge, chunks starting mid-block, an empty
    context."""
    q, kp, vp, bt, lens, sc, vdq = _prefill_inputs(
        0, 3, T, H, Kv, 32, bs, [0, 5, 77], int8)
    y = emulate_prefill(q, kp, vp, bt, lens, **sc)
    yr = ref.paged_prefill_attention_ref(q, kp, vp, bt, lens, **sc)
    err = float((y.float() - yr.float()).abs().max())
    assert bool(torch.isfinite(y.float()).all())
    assert err <= attn_tol(yr, vdq)
    # the rounding is seen: the emulation is not the plain version
    assert err > 0


@pytest.mark.parametrize("Sq,Sk,H,Kv,window", [(100, 100, 2, 2, 0),
                                                (80, 80, 2, 1, 30),
                                                (40, 150, 4, 2, 0)])
def test_flash_tile_rounding_within_the_bound(Sq, Sk, H, Kv, window):
    rng = np.random.default_rng(1)
    B, d = 2, 32
    q, k, v = (torch.from_numpy(rng.standard_normal((B, h, S, d))
                                .astype(np.float32)).to(torch.bfloat16)
               for h, S in ((H, Sq), (Kv, Sk), (Kv, Sk)))
    o = emulate_flash(q, k, v, window=window)
    orf = ref.flash_attention_ref(q, k, v, sliding_window=window)
    assert float((o.float() - orf.float()).abs().max()) <= attn_tol(orf, v)


def _pallas_prefill_within_the_bound(hd):
    q, kp, vp, bt, lens, _, _ = _prefill_inputs(2, 2, 16, 2, 2, hd, 8,
                                                [0, 13], False)
    yr = ref.paged_prefill_attention_ref(q, kp, vp, bt, lens)
    yj = j_paged_prefill(jnp.asarray(q.float().numpy(), jnp.bfloat16),
                         jnp.asarray(kp.float().numpy(), jnp.bfloat16),
                         jnp.asarray(vp.float().numpy(), jnp.bfloat16),
                         jnp.asarray(bt.numpy()), jnp.asarray(lens.numpy()),
                         interpret=True)
    yj = torch.from_numpy(np.asarray(yj, np.float32))
    assert float((yj - yr.float()).abs().max()) <= attn_tol(yr, vp)


def test_pallas_prefill_rounds_p_within_the_same_bound():
    """The TPU kernel (interpret mode) rounds P to the pool's bf16 before
    P·V, as the tile does: it stands within the same bound of the plain
    version."""
    _pallas_prefill_within_the_bound(128)


def test_pallas_prefill_at_head_dim_256_within_the_same_bound():
    """The same at gemma-2b's head dim 256, which the port's tile now
    takes."""
    _pallas_prefill_within_the_bound(256)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("T,H,Kv,bs", [(70, 2, 2, 16), (40, 4, 2, 8),
                                       (9, 1, 1, 16)])
def test_prefill_tile_ref_matches_the_per_cta_emulation(T, H, Kv, bs, int8):
    """The tile reference (a CTA's kv heads in one batch) against the
    per-CTA emulation (one kv head at a time), each CTA walking keys from
    0 to its last query."""
    q, kp, vp, bt, lens, sc, _ = _prefill_inputs(
        3, 3, T, H, Kv, 32, bs, [0, 5, 140], int8)
    y = emulate_prefill(q, kp, vp, bt, lens, **sc)
    yt = attn_tile.paged_prefill_tile_ref(q, kp, vp, bt, lens, **sc)
    assert attn_tile.tile_errors(yt, y)[1] <= 1.0


@pytest.mark.parametrize("window", [1, 16, 63, 64, 65, 100])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("T,H,Kv,bs", [(70, 2, 2, 16), (40, 4, 2, 8),
                                       (9, 1, 1, 16)])
def test_windowed_prefill_tile_ref_matches_the_per_cta_emulation(
        T, H, Kv, bs, int8, window):
    """With a sliding window each CTA walks from its first query's window
    start: the tile reference against the per-CTA emulation, and the
    window binds."""
    q, kp, vp, bt, lens, sc, _ = _prefill_inputs(
        3, 3, T, H, Kv, 32, bs, [0, 5, 140], int8)
    y = emulate_prefill(q, kp, vp, bt, lens, window=window, **sc)
    yt = attn_tile.paged_prefill_tile_ref(q, kp, vp, bt, lens,
                                          sliding_window=window, **sc)
    assert attn_tile.tile_errors(yt, y)[1] <= 1.0
    full = attn_tile.paged_prefill_tile_ref(q, kp, vp, bt, lens, **sc)
    assert not torch.equal(full, yt)


@pytest.mark.parametrize("window", [0, 16, 100])
@pytest.mark.parametrize("int8", [False, True])
def test_windowed_prefill_tile_rounding_within_the_bound(int8, window):
    """The emulated tile with a window against the plain version with the
    same window, at the rounding bound."""
    q, kp, vp, bt, lens, sc, vdq = _prefill_inputs(
        6, 3, 70, 4, 2, 32, 16, [0, 5, 140], int8)
    y = emulate_prefill(q, kp, vp, bt, lens, window=window, **sc)
    yr = ref.paged_prefill_attention_ref(q, kp, vp, bt, lens,
                                         sliding_window=window, **sc)
    assert float((y.float() - yr.float()).abs().max()) <= attn_tol(yr, vdq)


@pytest.mark.parametrize("int8", [False, True])
def test_head_dim_256_prefill_tile_ref_within_the_bound_of_the_oracle(int8):
    """gemma-2b's head dim (G 4, one kv head): the tile reference against
    the reference package's oracle (``repro.kernels.ref``) at the rounding
    bound, and against the per-CTA emulation row by row."""
    q, kp, vp, bt, lens, sc, vdq = _prefill_inputs(
        7, 2, 20, 4, 1, 256, 16, [0, 70], int8)
    yt = attn_tile.paged_prefill_tile_ref(q, kp, vp, bt, lens, **sc)
    jsc = {k: jnp.asarray(v.numpy()) for k, v in sc.items()}
    pools = [jnp.asarray(p.float().numpy()) if not int8 else
             jnp.asarray(p.numpy()) for p in (kp, vp)]
    yr = j_ref.paged_prefill_attention_ref(
        jnp.asarray(q.float().numpy()), *pools, jnp.asarray(bt.numpy()),
        jnp.asarray(lens.numpy()), **jsc)
    yr = torch.from_numpy(np.array(yr, np.float32))
    assert float((yt.float() - yr).abs().max()) <= attn_tol(yr, vdq)
    y = emulate_prefill(q, kp, vp, bt, lens, **sc)
    assert attn_tile.tile_errors(yt, y)[1] <= 1.0


@pytest.mark.parametrize("window", [0, 24])
def test_head_dim_256_flash_tile_ref_within_the_bound_of_the_oracle(window):
    """The flash tile reference at head dim 256 against the reference
    package's oracle at the rounding bound, and against the per-CTA
    emulation row by row."""
    rng = np.random.default_rng(8)
    B, H, Kv, S, d = 1, 2, 1, 80, 256
    q, k, v = (torch.from_numpy(rng.standard_normal((B, h, S, d))
                                .astype(np.float32)).to(torch.bfloat16)
               for h in (H, Kv, Kv))
    ot = attn_tile.flash_attention_tile_ref(q, k, v, sliding_window=window)
    rep = lambda t: jnp.repeat(jnp.asarray(t.float().numpy()), H // Kv, 1)
    orf = j_ref.flash_attention_ref(jnp.asarray(q.float().numpy()), rep(k),
                                    rep(v), causal=True,
                                    sliding_window=window)
    orf = torch.from_numpy(np.array(orf, np.float32))
    assert float((ot.float() - orf).abs().max()) <= attn_tol(orf, v)
    o = emulate_flash(q, k, v, window=window)
    assert attn_tile.tile_errors(ot, o)[1] <= 1.0


@pytest.mark.parametrize("int8", [False, True])
def test_prefill_tile_ref_ignores_slots_the_kernel_never_reads(int8):
    """NaN at every pool slot at or past lengths[b] + T and in the blocks no
    table points at: the reference is unchanged."""
    T, bs = 20, 8
    q, kp, vp, bt, lens, sc, _ = _prefill_inputs(
        4, 2, T, 4, 2, 32, bs, [3, 30], int8)
    # disjoint tables (``_prefill_inputs`` may share a block between rows)
    MB = bt.shape[1]
    bt = torch.randperm(2 * MB, generator=torch.Generator().manual_seed(4)
                        ).reshape(2, MB).to(torch.int32) + 1
    NB = kp.shape[0] + 2                       # 2 blocks no table points at
    pad = lambda t: torch.cat([t, torch.zeros((2,) + t.shape[1:],
                                              dtype=t.dtype)])
    kp, vp = pad(kp), pad(vp)
    sc = {k: pad(v) for k, v in sc.items()}
    clean = attn_tile.paged_prefill_tile_ref(q, kp, vp, bt, lens, **sc)
    poison = torch.ones((NB, bs), dtype=torch.bool)
    for b in range(bt.shape[0]):
        for i, blk in enumerate(bt[b].tolist()):
            poison[blk] = i * bs + torch.arange(bs) >= int(lens[b]) + T
    if int8:
        sc = {k: torch.where(poison[..., None], float("nan"), v)
              for k, v in sc.items()}
    else:
        nan = torch.tensor(float("nan"), dtype=kp.dtype)
        kp, vp = (torch.where(poison[..., None, None], nan, t)
                  for t in (kp, vp))
    y = attn_tile.paged_prefill_tile_ref(q, kp, vp, bt, lens, **sc)
    assert torch.equal(y, clean)


@pytest.mark.parametrize("Sq,Sk,H,Kv,window,causal",
                         [(100, 100, 2, 2, 0, True), (80, 80, 2, 1, 30, True),
                          (40, 150, 4, 2, 0, True),
                          (130, 130, 2, 2, 20, False)])
def test_flash_tile_ref_matches_the_per_cta_emulation(Sq, Sk, H, Kv, window,
                                                      causal):
    rng = np.random.default_rng(5)
    B, d = 2, 32
    q, k, v = (torch.from_numpy(rng.standard_normal((B, h, S, d))
                                .astype(np.float32)).to(torch.bfloat16)
               for h, S in ((H, Sq), (Kv, Sk), (Kv, Sk)))
    o = emulate_flash(q, k, v, causal=causal, window=window)
    ot = attn_tile.flash_attention_tile_ref(q, k, v, causal=causal,
                                            sliding_window=window)
    assert attn_tile.tile_errors(ot, o)[1] <= 1.0


def test_row_tol_is_two_bf16_ulps_of_each_row():
    out = torch.tensor([[1.0, -0.5], [0.0, 0.0], [3.0, 0.01]])
    assert attn_tile.row_tol(out).tolist() == [2 ** -6, 0.0, 2 ** -5]
    # a row of zeros holds only when it is matched exactly
    assert attn_tile.tile_errors(out, out) == (0.0, 0.0)
    off = out.clone()
    off[1, 0] = 1e-9
    assert attn_tile.tile_errors(off, out)[1] == float("inf")


def test_check_mma_tile_refuses_what_the_tile_does_not_take():
    x = torch.zeros((2, 3, 4, 64), dtype=torch.bfloat16)
    attn_tile.check_mma_tile(64, (("q", x), ("k", x.transpose(1, 2))))
    with pytest.raises(ValueError, match="head dims"):
        attn_tile.check_mma_tile(96, (("q", x),))
    flat = torch.zeros(2 * 3 * 4 * 64 + 8, dtype=torch.bfloat16)
    off = (-flat.data_ptr() // 2) % 8 + 1     # one element past 16 bytes
    with pytest.raises(ValueError, match="aligned"):
        attn_tile.check_mma_tile(64, (("q", flat[off:off + x.numel()]
                                       .view(x.shape)),))
    wide = torch.zeros((1, 2, 8, 65), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):    # row stride 130 B
        attn_tile.check_mma_tile(64, (("q", wide[..., :64]),))
