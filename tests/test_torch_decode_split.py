"""The decode kernel's split arithmetic against the reference package (CPU).

``paged_attention_split_ref`` is the plain model of the split-K decode
kernel (``csrc/paged_attention.cu``): each split's (m, l, acc), merged in
split order.  It is held to the reference oracle
(``repro.kernels.ref.paged_attention_ref``), to the Pallas kernel in
interpret mode (through ``repro.kernels.ops.paged_gqa_attention``) and to
the port's plain version, on the same numpy inputs, over split lengths of
one block, two blocks and more than any row.  With a sliding window, the
split model and the plain version are held to the reference's mask
(``repro.models.layers._attn_mask``) in numpy and to the port's "torch"
layer path.  The kernel itself is held to the plain version on the card
(``test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.quant import quantize_int8 as j_quantize
from repro_torch import kernels
from repro_torch.kernels import ref
from repro_torch.kernels.paged_attention import (SPLIT, paged_attention,
                                                 paged_attention_split_ref)
from test_torch_kernels import _layer_path, _windowed_prefill_oracle

# fp32 on both sides, the same inputs: only summation order differs
F32_TOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _case(rng, B, H, Kv, hd, NB, bs, MB, int8):
    """q, pools (bf16-representable fp32, or int8 + fp32 scales) and
    disjoint block tables over blocks 1..NB-1."""
    kf = rng.standard_normal((NB, bs, Kv, hd)).astype(np.float32)
    vf = rng.standard_normal((NB, bs, Kv, hd)).astype(np.float32)
    if int8:
        kq, ks = j_quantize(_j(kf), axis=-1)
        vq, vs = j_quantize(_j(vf), axis=-1)
        pools = [np.asarray(x) for x in (kq, vq, ks, vs)]
    else:
        pools = [np.asarray(_j(x).astype(jnp.bfloat16).astype(jnp.float32))
                 for x in (kf, vf)] + [None, None]
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    bt = np.stack([rng.permutation(np.arange(1, NB))[:MB]
                   for _ in range(B)]).astype(np.int32)
    return q, pools, bt


def _both(q, pools, bt, lens, split_len):
    """(port split model, reference oracle, Pallas interpret) outputs."""
    kp, vp, ks, vs = pools
    quant = ks is not None
    jsc = {"k_scale": _j(ks), "v_scale": _j(vs)} if quant else {}
    tsc = {"k_scale": _t(ks), "v_scale": _t(vs)} if quant else {}
    # the port takes bf16 pools as bf16 tensors; the values are the same
    tk, tv = ((_t(kp), _t(vp)) if quant else
              (_t(kp).to(torch.bfloat16), _t(vp).to(torch.bfloat16)))
    y = paged_attention_split_ref(_t(q), tk, tv, _t(bt), _t(lens),
                                  split_len=split_len, **tsc)
    yr = jref.paged_attention_ref(_j(q), _j(kp), _j(vp), _j(bt), _j(lens),
                                  **jsc)
    yp = jops.paged_gqa_attention(_j(q), _j(kp), _j(vp), _j(bt), _j(lens),
                                  **jsc)
    yt = ref.paged_attention_ref(_t(q), tk, tv, _t(bt), _t(lens), **tsc)
    return y, np.asarray(yr), np.asarray(yp), yt


@pytest.mark.parametrize("split", ["block", "two_blocks", "longer"])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("int8", [False, True])
def test_split_model_matches_reference(int8, G, split):
    """Lengths 0, 1, a split boundary +-1, rows whose last splits lie past
    their end; MB * bs = 28 is no multiple of a two-block split, so the
    last split runs past the table."""
    rng = np.random.default_rng(11 + G)
    Kv, hd, bs, MB = 2, 16, 4, 7
    cap = MB * bs
    S = {"block": bs, "two_blocks": 2 * bs, "longer": 32}[split]
    lens = sorted({n for n in (0, 1, S - 1, S, S + 1, 13, cap - 1, cap)
                   if 0 <= n <= cap})
    B = len(lens)
    q, pools, bt = _case(rng, B, G * Kv, Kv, hd, 1 + B * MB, bs, MB, int8)
    lens = np.asarray(lens, np.int32)
    y, yr, yp, yt = _both(q, pools, bt, lens, S)
    np.testing.assert_allclose(y.numpy(), yr, atol=F32_TOL)
    np.testing.assert_allclose(y.numpy(), yp, atol=F32_TOL)
    np.testing.assert_allclose(y.numpy(), yt.numpy(), atol=F32_TOL)
    np.testing.assert_array_equal(y[0].numpy(), 0.0)       # empty row


@pytest.mark.parametrize("int8", [False, True])
def test_split_model_at_the_kernel_split(int8):
    """The kernel's own SPLIT over a 320-position table: rows of one, two
    and three splits, GQA 4."""
    rng = np.random.default_rng(3)
    Kv, hd, bs, MB = 2, 32, 16, 20
    lens = np.asarray([0, SPLIT - 1, SPLIT, SPLIT + 1, 300, MB * bs],
                      np.int32)
    B = len(lens)
    q, pools, bt = _case(rng, B, 4 * Kv, Kv, hd, 1 + B * MB, bs, MB, int8)
    y, yr, yp, yt = _both(q, pools, bt, lens, SPLIT)
    np.testing.assert_allclose(y.numpy(), yr, atol=F32_TOL)
    np.testing.assert_allclose(y.numpy(), yp, atol=F32_TOL)
    np.testing.assert_allclose(y.numpy(), yt.numpy(), atol=F32_TOL)


@pytest.mark.parametrize("int8", [False, True])
def test_split_model_row_is_bitwise_independent_of_the_batch(int8):
    """A row alone gives bitwise the output it gives inside a larger batch,
    and a wider table (more splits past every row's end) changes nothing."""
    rng = np.random.default_rng(5)
    Kv, hd, bs, MB, S = 2, 16, 4, 9, 8
    lens = np.asarray([0, 1, 7, 8, 9, 17, 30, 36], np.int32)
    B = len(lens)
    q, (kp, vp, ks, vs), bt = _case(rng, B, 2 * Kv, Kv, hd, 1 + B * MB, bs,
                                    MB, int8)
    sc = {"k_scale": _t(ks), "v_scale": _t(vs)} if int8 else {}
    kp, vp, q, bt, lens = _t(kp), _t(vp), _t(q), _t(bt), _t(lens)
    if not int8:
        kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    y = paged_attention_split_ref(q, kp, vp, bt, lens, split_len=S, **sc)
    for b in range(B):
        alone = paged_attention_split_ref(q[b:b + 1], kp, vp, bt[b:b + 1],
                                          lens[b:b + 1], split_len=S, **sc)
        assert torch.equal(alone[0], y[b]), b
    wide = torch.cat([bt, bt[:, :5]], dim=1)
    assert torch.equal(paged_attention_split_ref(q, kp, vp, wide, lens,
                                                 split_len=S, **sc), y)


def test_cpu_wrapper_runs_the_plain_version_and_counts_nothing():
    rng = np.random.default_rng(9)
    q, (kp, vp, _, _), bt = _case(rng, 3, 4, 2, 32, 25, 16, 8, False)
    lens = _t(np.asarray([0, 130, 128], np.int32))
    kp, vp = _t(kp).to(torch.bfloat16), _t(vp).to(torch.bfloat16)
    kernels.reset_launch_counts()
    y = paged_attention(_t(q), kp, vp, _t(bt), lens)
    assert torch.equal(y, ref.paged_attention_ref(_t(q), kp, vp, _t(bt),
                                                  lens))
    f = paged_attention
    assert (f.launches, f.launches_split, f.launches_combine) == (0, 0, 0)


def _as_prefill(fn, q, kp, vp, ks, vs, bt, lens, W):
    """A decode step through a prefill helper (the numpy oracle or the
    "torch" layer path) at T = 1: the query at position ``lens - 1``; an
    empty row gives zeros."""
    empty = lens == 0
    at = lens - 1
    at[empty] = 0
    out = fn(q[:, None], kp, vp, ks, vs, bt, at, W)[:, 0]
    out[empty] = 0
    return out


WINDOWS = [1, 16, 127, 128, 129, 4096]


@pytest.mark.parametrize("W", WINDOWS)
@pytest.mark.parametrize("int8", [False, True])
def test_windowed_split_model_and_plain_match_the_reference_mask(int8, W):
    """Contexts on both sides of every split boundary up to 5 splits: the
    split model (whole splits below the window drop out) and the plain
    version against the reference's mask in numpy and the port's "torch"
    layer path."""
    rng = np.random.default_rng(20 + W)
    Kv, hd, bs, MB = 2, 16, 16, 40
    lens = np.asarray([0, 1, 2, 127, 128, 129, 255, 256, 257, 300, 500,
                       MB * bs], np.int32)
    B = len(lens)
    q, pools, bt = _case(rng, B, 4 * Kv, Kv, hd, 1 + B * MB, bs, MB, int8)
    kp, vp, ks, vs = pools
    want = _as_prefill(_windowed_prefill_oracle, q, kp, vp, ks, vs, bt,
                       lens, W)
    tsc = {"k_scale": _t(ks), "v_scale": _t(vs)} if int8 else {}
    tk, tv = ((_t(kp), _t(vp)) if int8 else
              (_t(kp).to(torch.bfloat16), _t(vp).to(torch.bfloat16)))
    y = paged_attention_split_ref(_t(q), tk, tv, _t(bt), _t(lens),
                                  sliding_window=W, **tsc)
    yt = ref.paged_attention_ref(_t(q), tk, tv, _t(bt), _t(lens),
                                 sliding_window=W, **tsc)
    yl = _as_prefill(_layer_path, _t(q), tk, tv, tsc.get("k_scale"),
                     tsc.get("v_scale"), _t(bt), _t(lens), W)
    for got in (y, yt):
        np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL)
    np.testing.assert_allclose(yt[1:].numpy(), yl[1:].numpy(), atol=F32_TOL)
    np.testing.assert_array_equal(y[0].numpy(), 0.0)
    if W < MB * bs:             # the window binds: not the full attention
        full = ref.paged_attention_ref(_t(q), tk, tv, _t(bt), _t(lens), **tsc)
        assert float((full[-1] - yt[-1]).abs().max()) > 1e-3


@pytest.mark.parametrize("W", [1, 9, 16, 17])
def test_windowed_split_model_row_is_bitwise_independent_of_the_batch(W):
    """With a window too, a row's output depends on its own length only:
    alone, inside the batch and over a wider table, bitwise."""
    rng = np.random.default_rng(6)
    Kv, hd, bs, MB, S = 2, 16, 4, 9, 8
    lens = np.asarray([0, 1, 7, 8, 9, 17, 30, 36], np.int32)
    B = len(lens)
    q, (kp, vp, _, _), bt = _case(rng, B, 2 * Kv, Kv, hd, 1 + B * MB, bs,
                                  MB, False)
    kp, vp = _t(kp).to(torch.bfloat16), _t(vp).to(torch.bfloat16)
    q, bt, lens = _t(q), _t(bt), _t(lens)
    kw = {"split_len": S, "sliding_window": W}
    y = paged_attention_split_ref(q, kp, vp, bt, lens, **kw)
    for b in range(B):
        alone = paged_attention_split_ref(q[b:b + 1], kp, vp, bt[b:b + 1],
                                          lens[b:b + 1], **kw)
        assert torch.equal(alone[0], y[b]), b
    wide = torch.cat([bt, bt[:, :5]], dim=1)
    assert torch.equal(paged_attention_split_ref(q, kp, vp, wide, lens,
                                                 **kw), y)
