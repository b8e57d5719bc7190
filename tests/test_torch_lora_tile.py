"""The tensor-core LoRA tile (``csrc/lora_mma.cuh``) from the CPU.

The tile runs only on a card; what surrounds it is plain Python, held here:
- which tile a call takes (``lora_tile``) and what the tensor-core tile
  refuses (``check_mma_tile``);
- the launch plan (``plan``, ``split_ranges``), a pure function of the
  shape: every K tile in exactly one split, in order, and enough CTAs at
  the decode shape;
- the scratch layout the wrappers hand the kernels (``tile_scratch``);
- the tile's arithmetic in plain PyTorch (``split_plan_ref``: K split as
  the plan splits it, A, z and B as two bf16 terms each where the tile
  uses the tensor cores), against the plain versions (``ref.py``) and
  against the Pallas kernels in interpret mode, on the same numpy inputs;
- the same for the two dual-LoRA kernels (``dual_split_plan_ref``: the
  merged pair for ``dual_lora_matmul``, two shrinks and the concatenated
  pair for ``batched_dual_lora_matmul``).
The card tests (``test_torch_cuda.py``) hold the kernels themselves to the
plain versions and to the tile models.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.batched_lora import batched_dual_lora_matmul as j_batched_dual
from repro.kernels.batched_lora import batched_lora_matmul as j_batched_lora
from repro.kernels.dual_lora import dual_lora_matmul as j_dual_lora
from repro.kernels.lora_matmul import lora_matmul as j_lora_matmul
from repro.kernels.quant import quantize_int8 as j_quantize
from repro_torch import kernels
from repro_torch.kernels import lora_tile, ref
from repro_torch.kernels.batched_lora import (batched_dual_lora_matmul,
                                              batched_lora_matmul, tile_scratch)
from repro_torch.kernels.dual_lora import dual_lora_matmul
from repro_torch.kernels.lora_matmul import lora_matmul

BF = torch.bfloat16
F32 = torch.float32


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _j(a):
    return jnp.asarray(np.asarray(a))


@pytest.mark.parametrize("x_dtype,w_dtype,tile", [
    (BF, BF, "mma"), (F32, F32, "f32"), (F32, BF, "f32"), (BF, F32, "f32")])
def test_dtype_picks_the_tile(x_dtype, w_dtype, tile):
    """bf16 activations with bf16 weights run the tensor-core tile; fp32
    activations (the tight checks) or fp32 weights the fp32 tile."""
    assert lora_tile.lora_tile(x_dtype, w_dtype) == tile


def test_lora_kernels_count_launches_by_tile():
    assert {"batched_lora_matmul", "lora_matmul"} <= set(kernels.TILES)
    kernels.reset_launch_counts()
    x = torch.zeros((3, 8), dtype=BF)
    w = torch.zeros((8, 8), dtype=BF)
    batched_lora_matmul(x, w, torch.zeros((2, 8, 4)), torch.zeros((2, 4, 8)),
                        torch.zeros((3,), dtype=torch.int32))
    lora_matmul(x, w, torch.zeros((8, 4)), torch.zeros((4, 8)))
    # CPU tensors run the plain versions: no launch on either tile
    counts = kernels.tile_counts()
    assert counts["batched_lora_matmul"] == {"mma": 0, "f32": 0}
    assert counts["lora_matmul"] == {"mma": 0, "f32": 0}


def test_dual_kernels_count_launches_by_tile():
    assert {"dual_lora_matmul", "batched_dual_lora_matmul"} <= set(
        kernels.TILES)
    kernels.reset_launch_counts()
    x = torch.zeros((3, 8), dtype=BF)
    w = torch.zeros((8, 8), dtype=BF)
    a, b = torch.zeros((8, 4)), torch.zeros((4, 8))
    dual_lora_matmul(x, w, a, b, a, b, torch.ones(2))
    batched_dual_lora_matmul(x, w, a[None], b[None], a, b,
                             torch.zeros((3,), dtype=torch.int32),
                             torch.ones((3, 2)))
    # CPU tensors run the plain versions: no launch on either tile
    counts = kernels.tile_counts()
    assert counts["dual_lora_matmul"] == {"mma": 0, "f32": 0}
    assert counts["batched_dual_lora_matmul"] == {"mma": 0, "f32": 0}


def test_check_mma_tile_refuses_unaligned_rows():
    ok_x, ok_w = torch.zeros((4, 16), dtype=BF), torch.zeros((16, 24), dtype=BF)
    lora_tile.check_mma_tile(ok_x, ok_w)
    with pytest.raises(ValueError, match="multiples of 8"):      # K = 12
        lora_tile.check_mma_tile(torch.zeros((4, 12), dtype=BF),
                                 torch.zeros((12, 24), dtype=BF))
    with pytest.raises(ValueError, match="multiples of 8"):      # N = 20
        lora_tile.check_mma_tile(ok_x, torch.zeros((16, 20), dtype=BF))
    flat = torch.zeros(4 * 16 + 1, dtype=BF)
    with pytest.raises(ValueError, match="aligned"):
        lora_tile.check_mma_tile(flat[1:].view(4, 16), ok_w)
    flat = torch.zeros(16 * 24 + 8, dtype=BF)
    with pytest.raises(ValueError, match="aligned"):
        lora_tile.check_mma_tile(ok_x, flat[4:4 + 16 * 24].view(16, 24))


SHAPES = [(1, 8, 8), (8, 104, 200), (8, 1032, 200), (8, 4096, 4096),
          (8, 11008, 4096), (40, 4096, 4096), (64, 520, 136),
          (65, 520, 136), (256, 4096, 4096), (2048, 4096, 11008),
          (2048, 11008, 4096), (2048, 264, 1032), (300, 4104, 264)]


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_plan_covers_every_k_once_in_order(M, K, N):
    p = lora_tile.plan(M, N, K)
    assert p == lora_tile.plan(M, N, K)               # a function of the shape
    for n_tiles, splits, least in (
            (-(-K // lora_tile.BK), p.split, lora_tile.MIN_K_TILES),
            (-(-K // lora_tile.SHRINK_K), p.zsplit, 1)):
        ranges = lora_tile.split_ranges(n_tiles, splits)
        assert ranges[0][0] == 0 and ranges[-1][1] == n_tiles
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        sizes = [hi - lo for lo, hi in ranges]
        assert max(sizes) - min(sizes) <= 1
        assert min(sizes) >= (least if splits > 1 else 1)
        covered = [t for lo, hi in ranges for t in range(lo, hi)]
        assert covered == list(range(n_tiles))        # each tile once


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_plan_picks_the_tile_by_rows(M, K, N):
    p = lora_tile.plan(M, N, K)
    assert p.kind == (0 if M <= 16 else 1 if M <= 64 else 2)
    if p.kind == 2:
        assert p.split == 1          # the wgmma tile never splits K
    bm, bn = lora_tile.TILES[p.kind]
    if p.split > 1:                  # split only while tiles are few
        assert -(-M // bm) * -(-N // bn) < lora_tile.NUM_SMS


def test_decode_shape_streams_w_from_every_sm():
    """Decode (8 rows, 4096 x 4096): narrow tiles plus split-K give at
    least as many CTAs as the card has SMs."""
    p = lora_tile.plan(8, 4096, 4096)
    bm, bn = lora_tile.TILES[p.kind]
    assert p.kind == 0 and p.split > 1
    assert -(-8 // bm) * -(-4096 // bn) * p.split >= lora_tile.NUM_SMS


@pytest.mark.parametrize("M,K,N", [(8, 4096, 4096), (2048, 4096, 11008),
                                   (70, 520, 200)])
def test_tile_scratch_is_aligned_and_disjoint(M, K, N):
    C, r = 5, 16
    p = lora_tile.plan(M, N, K)
    z, zpart, ypart, zl, bl = tile_scratch(p, "mma", M, N, C, r, "cpu")
    assert z.shape == (M, r) and z.dtype == F32
    parts = {"zpart": (zpart, 4 * p.zsplit * M * r, p.zsplit > 1),
             "ypart": (ypart, 4 * p.split * M * N, p.split > 1),
             "zl": (zl, 2 * M * 64, p.split == 1),
             "bl": (bl, 2 * C * 32 * N, p.split == 1)}
    spans = [(z.data_ptr(), z.data_ptr() + 4 * M * r)]
    for name, (ptr, nbytes, needed) in parts.items():
        assert (ptr is not None) == needed, name
        if ptr is not None:
            assert ptr % 16 == 0, name
            spans.append((ptr, ptr + nbytes))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    # the fp32 tile needs z only
    z32, *rest = tile_scratch(p, "f32", M, N, C, r, "cpu")
    assert z32.shape == (M, r) and rest == [None] * 4


@pytest.mark.parametrize("r", [1, 16, 128])
@pytest.mark.parametrize("M,K,N", [(8, 4096, 4096), (40, 520, 136),
                                   (2048, 4096, 11008), (70, 520, 200)])
def test_tile_scratch_dual_layout(M, K, N, r):
    """batched_dual_lora_matmul's scratch (``pairs=2``, C + 1 slots, the
    slots of its rows as an extra part) and dual_lora_matmul's (the merged
    pair as two extra parts): every part 16-byte aligned, disjoint, sized
    for the concatenated rank 2·16·ceil(r/16), where its plan needs it."""
    C = 5
    p = lora_tile.plan(M, N, K)
    nq2 = 2 * -(-r // 16)
    z, zpart, ypart, zl, bl, slot = tile_scratch(
        p, "mma", M, N, C + 1, r, "cpu", pairs=2, extra=(M,))
    assert z.shape == (2, M, r) and z.dtype == F32 and z.is_contiguous()
    parts = {"zpart": (zpart, 4 * 2 * p.zsplit * M * r, p.zsplit > 1),
             "ypart": (ypart, 4 * p.split * M * N, p.split > 1),
             "zl": (zl, 2 * M * nq2 * 64, p.split == 1),
             "bl": (bl, 2 * (C + 1) * nq2 * 32 * N, p.split == 1),
             "slot": (slot, 4 * M, True)}
    spans = [(z.data_ptr(), z.data_ptr() + 4 * 2 * M * r)]
    for name, (ptr, nbytes, needed) in parts.items():
        assert (ptr is not None) == needed, name
        if ptr is not None:
            assert ptr % 16 == 0, name
            spans.append((ptr, ptr + nbytes))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    # the fp32 tile: z only (it uses z[0]), no extra part
    z32, *rest = tile_scratch(p, "f32", M, N, C + 1, r, "cpu", pairs=2,
                              extra=(M,))
    assert z32.shape == (2, M, r) and rest == [None] * 5
    # dual_lora_matmul: lmma::run's scratch for one client, then the merged
    # pair (K, r) and (r, N) fp32
    z, zpart, ypart, zl, bl, am, bm = tile_scratch(
        p, "mma", M, N, 1, r, "cpu", extra=(K * r, r * N))
    assert z.shape == (M, r)
    spans = [(z.data_ptr(), z.data_ptr() + 4 * M * r),
             (am, am + 4 * K * r), (bm, bm + 4 * r * N)]
    spans += [(q, q + 1) for q in (zpart, ypart, zl, bl) if q is not None]
    assert all(q % 16 == 0 for q in (am, bm))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert tile_scratch(p, "f32", M, N, 1, r, "cpu",
                        extra=(K * r, r * N))[1:] == (None,) * 6


def test_hi_lo_is_within_2_to_the_minus_16():
    rng = np.random.default_rng(0)
    v = _t(rng.standard_normal(4096).astype(np.float32)
           * 10.0 ** rng.integers(-6, 6, 4096))
    hi, lo = lora_tile.hi_lo(v)
    assert torch.equal(hi, hi.to(BF).float()) and torch.equal(
        lo, lo.to(BF).float())
    assert bool(((hi + lo - v).abs() <= 2.0 ** -16 * v.abs()).all())
    q = torch.arange(-127, 128, dtype=torch.int8)     # int8 banks: exact
    hi, lo = lora_tile.hi_lo(q)
    assert torch.equal(hi, q.float()) and not bool(lo.any())


def _bank(rng, M, K, N, C, r, variant):
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    a = (rng.standard_normal((C, K, r)) / r).astype(np.float32)
    b = (rng.standard_normal((C, r, N)) * 0.05).astype(np.float32)
    kw = {}
    if variant == "rank_mask":
        kw["ranks"] = rng.integers(1, r + 1, C).astype(np.int32)
    if variant == "int8_bank":
        a, sa = (np.asarray(t) for t in j_quantize(_j(a), axis=(1, 2)))
        b, sb = (np.asarray(t) for t in j_quantize(_j(b), axis=(1, 2)))
        kw.update(a_scale=sa, b_scale=sb)
    return x, w, a, b, kw


def _plain(x, w, a, b, ids, kw):
    """The plain version with ids outside [0, C) giving x·W alone."""
    C = a.shape[0]
    dead = (ids < 0) | (ids >= C)
    y = ref.batched_lora_matmul_ref(x, w, a, b, torch.where(dead, 0, ids), 2.0,
                                    **kw)
    return torch.where(dead[:, None], (x.float() @ w.float()).to(x.dtype), y)


def _tol(y):
    # bf16: two bf16 roundings of the largest output (both round once from
    # fp32); fp32: A, z and B as two bf16 terms each are within 2^-16 of
    # fp32, a few times 2^-16 of the largest output, far under 1e-4
    top = float(y.float().abs().max())
    return top * (2.0 ** -7 if y.dtype == BF else 1e-4) + 1e-5


@pytest.mark.parametrize("dtype", [F32, BF])
@pytest.mark.parametrize("variant", ["f32_bank", "rank_mask", "int8_bank"])
@pytest.mark.parametrize("M,K,N", [(8, 1032, 200), (70, 264, 200),
                                   (40, 520, 136), (130, 200, 72)])
def test_split_plan_ref_matches_the_plain_version(M, K, N, variant, dtype):
    """The tile's arithmetic (split-K sums, hi/lo terms) against the plain
    version, under split and unsplit plans, mixed clients, dead ids."""
    rng = np.random.default_rng(M + K)
    C, r = 5, 16
    x, w, a, b, kw = _bank(rng, M, K, N, C, r, variant)
    ids = _t(np.repeat(rng.integers(-1, C + 1, M), rng.integers(1, 9, M))[:M]
             .astype(np.int32))
    xt, wt = _t(x).to(dtype), _t(w).to(dtype)
    kwt = {k: _t(v) for k, v in kw.items()}
    y, z = lora_tile.split_plan_ref(xt, wt, _t(a), _t(b), ids, 2.0, **kwt)
    yr = _plain(xt, wt, _t(a), _t(b), ids.long(), kwt)
    assert y.dtype == dtype and y.shape == (M, N) and z.shape == (M, r)
    assert float((y.float() - yr.float()).abs().max()) <= _tol(yr)


@pytest.mark.parametrize("variant", ["f32_bank", "rank_mask", "int8_bank"])
def test_split_plan_ref_matches_the_pallas_kernel(variant):
    """fp32 inputs through the Pallas batched kernel in interpret mode (its
    one-hot expand, fp32 throughout) and through the tile's arithmetic."""
    rng = np.random.default_rng(11)
    M, K, N, C, r = 32, 64, 48, 3, 8
    x, w, a, b, kw = _bank(rng, M, K, N, C, r, variant)
    ids = rng.integers(0, C, M).astype(np.int32)
    yp = np.asarray(j_batched_lora(_j(x), _j(w), _j(a), _j(b), _j(ids), 2.0,
                                   **{k: _j(v) for k, v in kw.items()},
                                   bm=8, bn=8, bk=8))
    for M_plan in (8, 2048):         # a split plan and an unsplit one
        p = lora_tile.plan(M_plan, N, K)
        y, _ = lora_tile.split_plan_ref(_t(x), _t(w), _t(a), _t(b), _t(ids),
                                        2.0, p=p,
                                        **{k: _t(v) for k, v in kw.items()})
        np.testing.assert_allclose(y.numpy(), yp,
                                   atol=1e-4 * np.abs(yp).max())
    yr = jref.batched_lora_matmul_ref(_j(x), _j(w), _j(a), _j(b), _j(ids), 2.0,
                                      **{k: _j(v) for k, v in kw.items()})
    np.testing.assert_allclose(y.numpy(), np.asarray(yr),
                               atol=1e-4 * np.abs(yp).max())


def test_split_plan_ref_one_client_matches_lora_matmul_kernel():
    """lora_matmul is the tile with one client and no ids: its fp32 z and
    y against the Pallas lora_matmul kernel (interpret mode, fp32) and the
    plain version."""
    rng = np.random.default_rng(12)
    M, K, N, r = 128, 256, 128, 8
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    a = (rng.standard_normal((K, r)) * 0.05).astype(np.float32)
    b = (rng.standard_normal((r, N)) * 0.05).astype(np.float32)
    y, z = lora_tile.split_plan_ref(_t(x), _t(w), _t(a)[None], _t(b)[None],
                                    None, 2.0)
    yk = np.asarray(j_lora_matmul(_j(x), _j(w), _j(a), _j(b), scale=2.0,
                                  bm=128, bn=128, bk=128))
    tol = 1e-4 * np.abs(yk).max()
    np.testing.assert_allclose(y.numpy(), yk, atol=tol)
    np.testing.assert_allclose(
        y.numpy(), ref.lora_matmul_ref(_t(x), _t(w), _t(a), _t(b), 2.0).numpy(),
        atol=tol)
    # z, which the backward reuses, within fp32 noise of x·A
    np.testing.assert_allclose(z.numpy(), x @ a, rtol=1e-4, atol=1e-5)


def _dual_bank(rng, M, K, N, C, r):
    """The reference test's dual inputs: fusion weights in [-0.2, 1.2],
    ids in [0, C) with one row at C and, for M > 2, one at -1 (outside the
    bank: the global term only)."""
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    a1 = (rng.standard_normal((C, K, r)) / r).astype(np.float32)
    b1 = (rng.standard_normal((C, r, N)) * 0.05).astype(np.float32)
    a2 = (rng.standard_normal((K, r)) / r).astype(np.float32)
    b2 = (rng.standard_normal((r, N)) * 0.05).astype(np.float32)
    ids = rng.integers(0, C, M).astype(np.int32)
    ids[M // 2] = C
    if M > 2:
        ids[-1] = -1
    fw = rng.uniform(-0.2, 1.2, (M, 2)).astype(np.float32)
    return x, w, a1, b1, a2, b2, ids, fw


def _dual_plain(x, w, a1, b1, a2, b2, ids, fw):
    """The plain per-row version with the kernels' rule for ids outside
    [0, C): no personalized term (w1 taken as 0)."""
    C = a1.shape[0]
    dead = (ids < 0) | (ids >= C)
    fw = torch.where(dead[:, None] & (torch.arange(2) == 0)[None],
                     torch.zeros_like(fw), fw)
    return ref.batched_dual_lora_matmul_ref(
        x, w, a1, b1, a2, b2, torch.where(dead, 0, ids), fw, 2.0)


@pytest.mark.parametrize("dtype", [F32, BF])
@pytest.mark.parametrize("r", [1, 16, 128])
@pytest.mark.parametrize("M", [8, 40, 300])
def test_dual_split_plan_ref_matches_the_plain_versions(M, r, dtype):
    """The dual tile model under every plan kind (M = 8: the 16 x 64 tile,
    split-K; 40: the 64 x 128 tile, split-K; 300: the wgmma tile, the LoRA
    term as hi/lo stages) against the plain versions: per-row weights with
    rows outside the bank (batched_dual_lora_matmul's route), and scalar
    weights (dual_lora_matmul's merged pair).  Tolerance: bf16, two bf16
    roundings of the largest output (both round once from fp32); fp32, the
    hi/lo terms and the linearity route's other order are a few times
    2^-16 of the largest output, under 1e-4 of it."""
    K, N, C = 520, 136, 3
    p = lora_tile.plan(M, N, K)
    assert p.kind == (0 if M <= 16 else 1 if M <= 64 else 2)
    assert (p.split > 1) == (M <= 64)
    rng = np.random.default_rng(M * 1000 + r)
    x, w, a1, b1, a2, b2, ids, fw = (_t(v) for v in
                                     _dual_bank(rng, M, K, N, C, r))
    x, w = x.to(dtype), w.to(dtype)
    y = lora_tile.dual_split_plan_ref(x, w, a1, b1, a2, b2, ids, fw, 2.0)
    yr = _dual_plain(x, w, a1, b1, a2, b2, ids.long(), fw)
    assert y.dtype == dtype and y.shape == (M, N)
    assert float((y.float() - yr.float()).abs().max()) <= _tol(yr)
    fs = _t(rng.uniform(-0.2, 1.2, 2).astype(np.float32))
    ys = lora_tile.dual_split_plan_ref(x, w, a1[0], b1[0], a2, b2, None, fs,
                                       2.0)
    ysr = ref.dual_lora_matmul_ref(x, w, a1[0], b1[0], a2, b2, fs[0], fs[1],
                                   2.0)
    assert ys.dtype == dtype and ys.shape == (M, N)
    assert float((ys.float() - ysr.float()).abs().max()) <= _tol(ysr)


@pytest.mark.parametrize("r", [1, 16, 128])
def test_dual_split_plan_ref_matches_the_pallas_kernels(r):
    """fp32 inputs through the Pallas dual kernels in interpret mode (fp32
    throughout; the batched kernel's zero one-hot row gives a row outside
    the bank the global term only) and through the dual tile model under a
    split plan and an unsplit one: within 1e-4 of the largest output (the
    model's hi/lo terms are within 2^-16 each)."""
    rng = np.random.default_rng(21 + r)
    M, K, N, C = 32, 512, 48, 3
    x, w, a1, b1, a2, b2, ids, fw = _dual_bank(rng, M, K, N, C, r)
    yp = np.asarray(j_batched_dual(_j(x), _j(w), _j(a1), _j(b1), _j(a2),
                                   _j(b2), _j(ids), _j(fw), 2.0, bm=32,
                                   bn=16, bk=128))
    fs = rng.uniform(-0.2, 1.2, 2).astype(np.float32)
    ysp = np.asarray(j_dual_lora(_j(x), _j(w), _j(a1[1]), _j(b1[1]), _j(a2),
                                 _j(b2), _j(fs), scale=2.0, bm=32, bn=16,
                                 bk=128))
    for M_plan, split in ((8, True), (2048, False)):
        p = lora_tile.plan(M_plan, N, K)
        assert (p.split > 1) == split and p.zsplit > 1
        y = lora_tile.dual_split_plan_ref(
            _t(x), _t(w), _t(a1), _t(b1), _t(a2), _t(b2), _t(ids), _t(fw),
            2.0, p=p)
        np.testing.assert_allclose(y.numpy(), yp,
                                   atol=1e-4 * np.abs(yp).max())
        ys = lora_tile.dual_split_plan_ref(
            _t(x), _t(w), _t(a1[1]), _t(b1[1]), _t(a2), _t(b2), None, _t(fs),
            2.0, p=p)
        np.testing.assert_allclose(ys.numpy(), ysp,
                                   atol=1e-4 * np.abs(ysp).max())
