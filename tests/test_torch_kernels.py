"""The port's kernel modules against the reference package on the CPU.

Each plain version (``repro_torch.kernels.ref``) is held against the
reference oracle of the same name (``repro.kernels.ref``) and against the
Pallas kernel run in interpret mode, on the same numpy inputs.  On CPU
tensors the wrappers run the plain version and launch nothing.  The
card-only tests are in ``test_torch_cuda.py``.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.batched_lora import \
    batched_dual_lora_matmul as j_batched_dual
from repro.kernels.batched_lora import batched_lora_matmul as j_batched_lora
from repro.kernels.paged_prefill import paged_scatter as j_scatter
from repro.kernels.paged_prefill import paged_scatter_quant as j_scatter_quant
from repro.kernels.quant import quantize_int8 as j_quantize
from repro.models.layers import _attn_mask as j_attn_mask
from repro_torch import kernels
from repro_torch.kernels import ops, ref
from repro_torch.kernels.batched_lora import (batched_dual_lora_matmul,
                                              batched_lora_matmul)
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.paged_prefill import (paged_prefill_attention,
                                               paged_scatter,
                                               paged_scatter_quant)
from repro_torch.kernels.quant import dequantize_int8, quantize_int8
from repro_torch.models import layers

# fp32 on both sides, the same inputs: only summation order differs
F32_TOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _pools(rng, NB, bs, Kv, hd, int8):
    """bf16-representable fp32 pools (or int8 pools + fp32 scales)."""
    kf = rng.standard_normal((NB, bs, Kv, hd)).astype(np.float32)
    vf = rng.standard_normal((NB, bs, Kv, hd)).astype(np.float32)
    if int8:
        kq, ks = j_quantize(_j(kf), axis=-1)
        vq, vs = j_quantize(_j(vf), axis=-1)
        return [np.asarray(x) for x in (kq, vq, ks, vs)]
    kb = np.asarray(_j(kf).astype(jnp.bfloat16).astype(jnp.float32))
    vb = np.asarray(_j(vf).astype(jnp.bfloat16).astype(jnp.float32))
    return kb, vb, None, None


def _tables(rng, B, MB, NB):
    return np.stack([rng.permutation(np.arange(1, NB))[:MB]
                     for _ in range(B)]).astype(np.int32)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("H,Kv", [(4, 4), (8, 2)])
def test_paged_attention_plain_matches_reference(H, Kv, int8):
    rng = np.random.default_rng(1)
    B, hd, NB, bs, MB = 5, 16, 24, 4, 4
    kp, vp, ks, vs = _pools(rng, NB, bs, Kv, hd, int8)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    bt = _tables(rng, B, MB, NB)
    lens = np.asarray([0, 1, 7, 13, 16], np.int32)     # ragged, one empty
    sc = {} if not int8 else {"k_scale": ks, "v_scale": vs}
    y = ref.paged_attention_ref(_t(q), _t(kp), _t(vp), _t(bt), _t(lens),
                                **{k: _t(v) for k, v in sc.items()})
    yr = jref.paged_attention_ref(_j(q), _j(kp), _j(vp), _j(bt), _j(lens),
                                  **{k: _j(v) for k, v in sc.items()})
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=F32_TOL)
    np.testing.assert_array_equal(y[0].numpy(), 0.0)   # empty row -> zeros
    # the Pallas kernel in interpret mode, through its model-layout wrapper
    yp = jops.paged_gqa_attention(_j(q), _j(kp), _j(vp), _j(bt), _j(lens),
                                  **{k: _j(v) for k, v in sc.items()})
    np.testing.assert_allclose(y.numpy(), np.asarray(yp), atol=F32_TOL)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("H,Kv", [(4, 4), (4, 2)])
def test_paged_prefill_plain_matches_reference(H, Kv, int8):
    """Through the model-layout wrapper: scatter the chunk (ragged tails to
    scratch block 0), then attend; pools and outputs against the reference
    wrapper, which runs the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(2)
    B, T, hd, NB, bs, MB = 3, 4, 16, 16, 4, 4
    kp, vp, ks, vs = _pools(rng, NB, bs, Kv, hd, int8)
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    kn = rng.standard_normal((B, T, Kv, hd)).astype(np.float32)
    vn = rng.standard_normal((B, T, Kv, hd)).astype(np.float32)
    bt = _tables(rng, B, MB, NB)
    lens = np.asarray([0, 5, 13], np.int32)
    n_new = np.asarray([4, 2, 3], np.int32)
    if int8:
        o, kp2, vp2, ks2, vs2 = ops.paged_prefill_gqa_attention(
            _t(q), _t(kn), _t(vn), _t(kp), _t(vp), _t(bt), _t(lens),
            _t(n_new), k_scale=_t(ks), v_scale=_t(vs))
        jo, jkp, jvp, jks, jvs = jops.paged_prefill_gqa_attention(
            _j(q), _j(kn), _j(vn), _j(kp), _j(vp), _j(bt), _j(lens),
            _j(n_new), k_scale=_j(ks), v_scale=_j(vs))
        np.testing.assert_array_equal(kp2.numpy()[1:], np.asarray(jkp)[1:])
        np.testing.assert_allclose(ks2.numpy()[1:], np.asarray(jks)[1:],
                                   rtol=1e-6)
    else:
        kpb, vpb = _t(kp).to(torch.bfloat16), _t(vp).to(torch.bfloat16)
        o, kp2, vp2 = ops.paged_prefill_gqa_attention(
            _t(q), _t(kn), _t(vn), kpb, vpb, _t(bt), _t(lens), _t(n_new))
        jo, jkp, jvp = jops.paged_prefill_gqa_attention(
            _j(q), _j(kn), _j(vn), _j(kp).astype(jnp.bfloat16),
            _j(vp).astype(jnp.bfloat16), _j(bt), _j(lens), _j(n_new))
        # block 0 is scratch: ragged tails land there in either order
        np.testing.assert_array_equal(
            kp2.float().numpy()[1:], np.asarray(jkp, np.float32)[1:])
        np.testing.assert_array_equal(
            vp2.float().numpy()[1:], np.asarray(jvp, np.float32)[1:])
    valid = np.arange(T)[None, :] < n_new[:, None]
    # with bf16 pools the Pallas kernel rounds its probabilities to the pool
    # dtype before the value product (the plain version keeps them fp32):
    # one bf16 rounding of outputs of magnitude ~1
    tol = F32_TOL if int8 else 1e-2
    np.testing.assert_allclose(o.numpy()[valid], np.asarray(jo)[valid],
                               atol=tol)
    # the plain version on the reference's updated pools, every row (tails
    # included), against the reference oracle: fp32 on both sides
    pools = [np.asarray(p) if int8 else np.asarray(p, np.float32)
             for p in (jkp, jvp)]
    sc = {} if not int8 else {"k_scale": np.asarray(jks),
                              "v_scale": np.asarray(jvs)}
    y = ref.paged_prefill_attention_ref(_t(q), _t(pools[0]), _t(pools[1]),
                                        _t(bt), _t(lens),
                                        **{k: _t(v) for k, v in sc.items()})
    yr = jref.paged_prefill_attention_ref(_j(q), jkp, jvp, _j(bt), _j(lens),
                                          **{k: _j(v) for k, v in sc.items()})
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=F32_TOL)


def test_paged_scatter_matches_reference_with_tails_past_the_table():
    """Tail tokens (t >= n_new) whose position lies past the table width
    go to scratch block 0, as in the reference (whose gather clamps)."""
    rng = np.random.default_rng(3)
    B, S, Kv, hd, NB, bs, MB = 3, 6, 2, 8, 10, 4, 2
    kp = rng.standard_normal((NB, bs, Kv, hd)).astype(np.float32)
    vp = rng.standard_normal((NB, bs, Kv, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Kv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Kv, hd)).astype(np.float32)
    bt = _tables(rng, B, MB, NB)
    lens = np.asarray([0, 5, 7], np.int32)             # 7 + 5 > MB * bs
    n_new = np.asarray([6, 3, 1], np.int32)
    tk, tv = paged_scatter(_t(kp), _t(vp), _t(k), _t(v), _t(bt), _t(lens),
                           _t(n_new))
    jk, jv = j_scatter(_j(kp), _j(vp), _j(k), _j(v), _j(bt), _j(lens),
                       _j(n_new))
    np.testing.assert_array_equal(tk.numpy()[1:], np.asarray(jk)[1:])
    np.testing.assert_array_equal(tv.numpy()[1:], np.asarray(jv)[1:])
    # quantized scatter: same coordinates, same int8 values and scales
    q = [np.zeros((NB, bs, Kv, hd), np.int8)] * 2
    s = [np.zeros((NB, bs, Kv), np.float32)] * 2
    out = paged_scatter_quant(_t(q[0]), _t(q[1]), _t(s[0]), _t(s[1]), _t(k),
                              _t(v), _t(bt), _t(lens), _t(n_new))
    jout = j_scatter_quant(*(_j(a) for a in (q[0], q[1], s[0], s[1], k, v,
                                             bt, lens, n_new)))
    for a, b in zip(out, jout):
        np.testing.assert_allclose(a.numpy()[1:], np.asarray(b)[1:],
                                   rtol=1e-6)


def test_quantize_int8_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 7)).astype(np.float32)
    x[1] = 0.0                                         # all-zero group
    for dim in (-1, (1, 2)):
        q, s = quantize_int8(_t(x), dim)
        jq, js = j_quantize(_j(x), axis=dim)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7)
        back = dequantize_int8(q, s, dim).numpy()
        np.testing.assert_allclose(back, x, atol=float(np.abs(x).max()) / 127)


@pytest.mark.parametrize("variant", ["f32_bank", "rank_mask", "int8_bank"])
def test_batched_lora_plain_matches_reference(variant):
    rng = np.random.default_rng(5)
    M, K, N, C, r = 24, 32, 40, 3, 8
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.1).astype(np.float32)
    a = (rng.standard_normal((C, K, r)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((C, r, N)) * 0.1).astype(np.float32)
    ids = rng.integers(0, C, M).astype(np.int32)
    kw = {}
    if variant == "rank_mask":
        kw["ranks"] = np.asarray([2, 8, 5], np.int32)
    if variant == "int8_bank":
        a, sa = (np.asarray(t) for t in j_quantize(_j(a), axis=(1, 2)))
        b, sb = (np.asarray(t) for t in j_quantize(_j(b), axis=(1, 2)))
        kw.update(a_scale=sa, b_scale=sb)
    y = ref.batched_lora_matmul_ref(_t(x), _t(w), _t(a), _t(b), _t(ids), 2.0,
                                    **{k: _t(v) for k, v in kw.items()})
    yr = jref.batched_lora_matmul_ref(_j(x), _j(w), _j(a), _j(b), _j(ids),
                                      2.0, **{k: _j(v) for k, v in kw.items()})
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=1e-5)
    # the Pallas kernel in interpret mode (fp32 inputs, fp32 throughout)
    yp = j_batched_lora(_j(x), _j(w), _j(a), _j(b), _j(ids), 2.0,
                        **{k: _j(v) for k, v in kw.items()},
                        bm=8, bn=8, bk=8)
    np.testing.assert_allclose(y.numpy(), np.asarray(yp), atol=1e-5)


def test_batched_lora_dense_routes_rows_per_request():
    """Model layout (B, S, K): each batch row's ids broadcast over S."""
    rng = np.random.default_rng(6)
    B, S, K, N, C, r = 3, 5, 16, 12, 4, 4
    x = rng.standard_normal((B, S, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    bank = {"a": rng.standard_normal((C, K, r)).astype(np.float32),
            "b": rng.standard_normal((C, r, N)).astype(np.float32)}
    ids = np.asarray([3, 0, 2], np.int32)
    y = ops.batched_lora_dense(_t(x), _t(w), {k: _t(v) for k, v in
                                              bank.items()}, _t(ids), 0.5)
    yr = jref.batched_lora_matmul_ref(
        _j(x.reshape(-1, K)), _j(w), _j(bank["a"]), _j(bank["b"]),
        _j(np.repeat(ids, S)), 0.5)
    np.testing.assert_allclose(y.numpy().reshape(-1, N), np.asarray(yr),
                               atol=1e-4)


def test_wrappers_run_plain_version_on_cpu_and_launch_nothing():
    rng = np.random.default_rng(7)
    kernels.reset_launch_counts()
    kp, vp, _, _ = _pools(rng, 8, 4, 2, 8, False)
    kpb, vpb = _t(kp).to(torch.bfloat16), _t(vp).to(torch.bfloat16)
    bt = _t(_tables(rng, 2, 3, 8))
    lens = _t(np.asarray([3, 9], np.int32))
    q = _t(rng.standard_normal((2, 4, 8)).astype(np.float32))
    np.testing.assert_array_equal(
        paged_attention(q, kpb, vpb, bt, lens).numpy(),
        ref.paged_attention_ref(q, kpb, vpb, bt, lens).numpy())
    q4 = _t(rng.standard_normal((2, 2, 4, 8)).astype(np.float32))
    np.testing.assert_array_equal(
        paged_prefill_attention(q4, kpb, vpb, bt, lens).numpy(),
        ref.paged_prefill_attention_ref(q4, kpb, vpb, bt, lens).numpy())
    x = _t(rng.standard_normal((4, 8)).astype(np.float32))
    w = _t(rng.standard_normal((8, 6)).astype(np.float32))
    a = _t(rng.standard_normal((2, 8, 3)).astype(np.float32))
    b = _t(rng.standard_normal((2, 3, 6)).astype(np.float32))
    ids = _t(np.asarray([1, 0, 1, 1], np.int32))
    np.testing.assert_array_equal(
        batched_lora_matmul(x, w, a, b, ids, 2.0).numpy(),
        ref.batched_lora_matmul_ref(x, w, a, b, ids, 2.0).numpy())
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)


def test_wrappers_reject_bad_shapes():
    q = torch.zeros((2, 4, 8))
    pool = torch.zeros((6, 4, 3, 8), dtype=torch.bfloat16)   # 4 % 3 != 0
    bt = torch.zeros((2, 2), dtype=torch.int32)
    lens = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError):
        paged_attention(q, pool, pool, bt, lens)
    with pytest.raises(ValueError):
        batched_lora_matmul(torch.zeros((3, 8)), torch.zeros((7, 5)),
                            torch.zeros((2, 8, 2)), torch.zeros((2, 2, 5)),
                            torch.zeros((3,), dtype=torch.int32))


def _dual_inputs(rng, M, K, N, C, r):
    """The reference test's inputs (``tests/test_multitenant.py``): per-row
    clients and fusion weights drawn in [-0.2, 1.2]."""
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    a1 = (rng.standard_normal((C, K, r)) * 0.05).astype(np.float32)
    b1 = (rng.standard_normal((C, r, N)) * 0.05).astype(np.float32)
    a2 = (rng.standard_normal((K, r)) * 0.05).astype(np.float32)
    b2 = (rng.standard_normal((r, N)) * 0.05).astype(np.float32)
    g = rng.integers(0, C, M).astype(np.int32)
    fw = rng.uniform(-0.2, 1.2, (M, 2)).astype(np.float32)
    return x, w, a1, b1, a2, b2, g, fw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r", [8, 16])
def test_batched_dual_lora_plain_matches_pallas(r, dtype):
    """The plain version against the reference oracle and the Pallas kernel
    in interpret mode, every row with its own client and (w1, w2).  fp32:
    within 1e-5 of the largest output.  bf16 inputs: the Pallas kernel
    rounds the factors and the shrunk rows to bf16 before its products
    (the plain version keeps fp32 and rounds once), so within two bf16
    roundings of the largest output."""
    rng = np.random.default_rng(40 + r)
    M, K, N, C = 64, 128, 128, 4
    x, w, a1, b1, a2, b2, g, fw = _dual_inputs(rng, M, K, N, C, r)
    jdt = jnp.dtype(dtype)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jx, jw = _j(x).astype(jdt), _j(w).astype(jdt)
    tx, tw = _t(x).to(tdt), _t(w).to(tdt)
    y = ref.batched_dual_lora_matmul_ref(tx, tw, _t(a1), _t(b1), _t(a2),
                                         _t(b2), _t(g), _t(fw), 2.0)
    assert y.dtype == tdt and tuple(y.shape) == (M, N)
    yr = jref.batched_dual_lora_matmul_ref(jx, jw, _j(a1), _j(b1), _j(a2),
                                           _j(b2), _j(g), _j(fw), 2.0)
    yp = j_batched_dual(jx, jw, _j(a1), _j(b1), _j(a2), _j(b2), _j(g),
                        _j(fw), 2.0, bm=32, bn=64, bk=64)
    yf = y.float().numpy()
    top = float(np.abs(np.asarray(yr, np.float32)).max())
    if dtype == "float32":
        tol = 1e-5 * top
        np.testing.assert_allclose(yf, np.asarray(yr), atol=tol)
    else:
        tol = top * 2.0 ** -7
        # the two oracles compute the same fp32 chain and round once each
        np.testing.assert_allclose(yf, np.asarray(yr, np.float32), atol=tol)
    np.testing.assert_allclose(yf, np.asarray(yp, np.float32), atol=tol)
    # the wrapper runs the plain version on CPU tensors and launches nothing
    kernels.reset_launch_counts()
    yw = batched_dual_lora_matmul(tx, tw, _t(a1), _t(b1), _t(a2), _t(b2),
                                  _t(g), _t(fw), 2.0)
    np.testing.assert_array_equal(yw.float().numpy(), yf)
    assert kernels.launch_counts()["batched_dual_lora_matmul"] == 0


def test_batched_dual_row_reduces_to_merged_single():
    """Rows sharing one (w1, w2) equal the pre-merged Eq. 7 bank through
    ``batched_lora_matmul``, in the port and in the Pallas kernel."""
    rng = np.random.default_rng(9)
    M, K, N, C, r = 32, 64, 48, 2, 8
    x, w, a1, b1, a2, b2, g, _ = _dual_inputs(rng, M, K, N, C, r)
    w1, w2 = 0.7, 0.4
    fw = np.tile(np.asarray([[w1, w2]], np.float32), (M, 1))
    y = batched_dual_lora_matmul(_t(x), _t(w), _t(a1), _t(b1), _t(a2),
                                 _t(b2), _t(g), _t(fw), 2.0)
    am = w1 * a1 + w2 * a2[None]
    bm = w1 * b1 + w2 * b2[None]
    ym = batched_lora_matmul(_t(x), _t(w), _t(am), _t(bm), _t(g), 2.0)
    top = float(ym.abs().max())
    np.testing.assert_allclose(y.numpy(), ym.numpy(), atol=1e-5 * top)
    yp = j_batched_dual(_j(x), _j(w), _j(a1), _j(b1), _j(a2), _j(b2), _j(g),
                        _j(fw), 2.0, bm=32, bn=16, bk=16)
    np.testing.assert_allclose(y.numpy(), np.asarray(yp), atol=1e-5 * top)


def test_batched_dual_wrapper_rejects_bad_shapes():
    x, w = torch.zeros((3, 8)), torch.zeros((8, 5))
    a1, b1 = torch.zeros((2, 8, 4)), torch.zeros((2, 4, 5))
    a2, b2 = torch.zeros((8, 4)), torch.zeros((4, 5))
    ids = torch.zeros((3,), dtype=torch.int32)
    with pytest.raises(ValueError, match="fusion_w"):
        batched_dual_lora_matmul(x, w, a1, b1, a2, b2, ids,
                                 torch.zeros((3, 3)))
    with pytest.raises(ValueError, match="a2"):
        batched_dual_lora_matmul(x, w, a1, b1, torch.zeros((8, 3)), b2, ids,
                                 torch.zeros((3, 2)))


def _ragged_bank(rng, K, N, sizes, ranks, int8):
    """Per-bucket lists of (C_b, K, r_b) / (C_b, r_b, N) factors (int8 plus
    per-client scales when ``int8``), as a ragged registry holds them."""
    bank = {"a": [], "b": []}
    if int8:
        bank["a_scale"], bank["b_scale"] = [], []
    for cb, rb in zip(sizes, ranks):
        a = (rng.standard_normal((cb, K, rb)) * 0.1).astype(np.float32)
        b = (rng.standard_normal((cb, rb, N)) * 0.1).astype(np.float32)
        if int8:
            a, sa = (np.asarray(t) for t in j_quantize(_j(a), axis=(1, 2)))
            b, sb = (np.asarray(t) for t in j_quantize(_j(b), axis=(1, 2)))
            bank["a_scale"].append(sa)
            bank["b_scale"].append(sb)
        bank["a"].append(a)
        bank["b"].append(b)
    return bank


@pytest.mark.parametrize("int8", [False, True])
def test_batched_lora_dense_on_list_banks_matches_reference(int8):
    """``ops.batched_lora_dense`` on a ragged bank's per-bucket lists equals
    the reference wrapper (Pallas kernel in interpret mode) and the model's
    plain ``lora_delta`` path; the registry-style concatenated view with
    its ``ranks`` vector gives the same output."""
    from repro_torch.models import layers as L
    rng = np.random.default_rng(11)
    B, S, K, N = 4, 3, 64, 64
    bank = _ragged_bank(rng, K, N, [2, 2, 1], [2, 4, 8], int8)
    x = rng.standard_normal((B, S, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.1).astype(np.float32)
    ids = np.asarray([4, 0, 3, 2], np.int32)
    tbank = {k: [_t(v) for v in vs] for k, vs in bank.items()}
    y = ops.batched_lora_dense(_t(x), _t(w), tbank, _t(ids), 2.0)
    yj = jops.batched_lora_dense(_j(x), _j(w),
                                 {k: [_j(v) for v in vs]
                                  for k, vs in bank.items()},
                                 _j(ids), 2.0, block=64)
    # the reference wrapper feeds its kernel bf16 activations
    top = float(np.abs(np.asarray(yj, np.float32)).max())
    np.testing.assert_allclose(y.numpy(), np.asarray(yj, np.float32),
                               atol=top * 2.0 ** -7)
    cat = ops.concat_buckets(tbank)
    assert cat["ranks"].tolist() == [2, 2, 4, 4, 8]
    yc = ops.batched_lora_dense(_t(x), _t(w), cat, _t(ids), 2.0)
    np.testing.assert_allclose(yc.numpy(), y.numpy(), atol=1e-5 * top)
    # the model's dense layer on the torch path routes rows by bucket
    yd = L.dense(_t(x), _t(w), L.LoRA(tbank["a"], tbank["b"],
                                      tbank.get("a_scale"),
                                      tbank.get("b_scale")),
                 2.0, _t(ids), backend="torch")
    np.testing.assert_allclose(yd.numpy(), y.numpy(), atol=1e-5 * top)


def _windowed_prefill_oracle(q, kp, vp, ks, vs, bt, lens, W):
    """Chunked prefill in numpy (fp64) under the mask the reference builds
    (``repro.models.layers._attn_mask``): query t of row b at position
    ``lens[b] + t``."""
    B, T, H, hd = q.shape
    bs, Kv = kp.shape[1], kp.shape[2]
    L = bt.shape[1] * bs
    k = kp[bt].reshape(B, L, Kv, hd).astype(np.float64)
    v = vp[bt].reshape(B, L, Kv, hd).astype(np.float64)
    if ks is not None:
        k = k * ks[bt].reshape(B, L, Kv)[..., None]
        v = v * vs[bt].reshape(B, L, Kv)[..., None]
    k, v = np.repeat(k, H // Kv, axis=2), np.repeat(v, H // Kv, axis=2)
    out = np.zeros((B, T, H, hd))
    for b in range(B):
        mask = np.asarray(j_attn_mask(jnp.arange(T) + int(lens[b]),
                                      jnp.arange(L), W))          # (T, L)
        s = np.einsum("thd,khd->htk", q[b], k[b]) * hd ** -0.5
        s = np.where(mask[None], s, -np.inf)
        p = np.exp(s - s.max(-1, keepdims=True))
        out[b] = np.einsum("htk,khd->thd", p / p.sum(-1, keepdims=True),
                           v[b])
    return out


def _layer_path(q, kp, vp, ks, vs, bt, lens, W):
    """The port's "torch" paged branch (``layers._sdpa`` under
    ``layers._attn_mask``, one chunk position at a time) on the same pools:
    q (B, T, H, hd), query t of row b at position ``lens[b] + t``."""
    B, T, H, hd = q.shape
    bs, Kv = kp.shape[1], kp.shape[2]
    L = bt.shape[1] * bs
    k = kp[bt.long()].reshape(B, L, Kv, hd).float()
    v = vp[bt.long()].reshape(B, L, Kv, hd).float()
    if ks is not None:
        k = k * ks[bt.long()].reshape(B, L, Kv)[..., None]
        v = v * vs[bt.long()].reshape(B, L, Kv)[..., None]
    cfg = types.SimpleNamespace(attn_logit_softcap=0.0)
    pos = lens.long()[:, None] + torch.arange(T)[None, :]
    out = [layers._sdpa(q[:, t:t + 1].float(), k, v, cfg,
                        layers._attn_mask(pos[:, t], torch.arange(L),
                                          W)[:, None], torch.float32)
           for t in range(T)]
    return torch.cat(out, dim=1).reshape(B, T, H, hd)


@pytest.mark.parametrize("W", [1, 5, 16, 17, 40])
@pytest.mark.parametrize("int8", [False, True])
def test_windowed_paged_prefill_plain_matches_the_reference_mask(int8, W):
    """The plain version with a sliding window against the reference's
    mask in numpy, and against the port's "torch" paged branch
    (``layers._sdpa`` under ``layers._attn_mask``, one chunk position at a
    time) on the same pools."""
    rng = np.random.default_rng(30 + W)
    B, T, H, Kv, hd, bs, MB = 3, 20, 4, 2, 16, 4, 12
    NB = 1 + B * MB
    kp, vp, ks, vs = _pools(rng, NB, bs, Kv, hd, int8)
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    bt = _tables(rng, B, MB, NB)
    lens = np.asarray([0, 9, 28], np.int32)
    want = _windowed_prefill_oracle(q, kp, vp, ks, vs, bt, lens, W)
    tsc = {"k_scale": _t(ks), "v_scale": _t(vs)} if int8 else {}
    tk, tv = ((_t(kp), _t(vp)) if int8 else
              (_t(kp).to(torch.bfloat16), _t(vp).to(torch.bfloat16)))
    y = ref.paged_prefill_attention_ref(_t(q), tk, tv, _t(bt), _t(lens),
                                        sliding_window=W, **tsc)
    np.testing.assert_allclose(y.numpy(), want, atol=F32_TOL)
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(paged_prefill_attention(
        _t(q), tk, tv, _t(bt), _t(lens), sliding_window=W, **tsc), y)
    yl = _layer_path(_t(q), tk, tv, tsc.get("k_scale"), tsc.get("v_scale"),
                     _t(bt), _t(lens), W)
    np.testing.assert_allclose(y.numpy(), yl.numpy(), atol=F32_TOL)


@pytest.mark.parametrize("int8", [False, True])
def test_head_dim_256_plain_versions_match_reference(int8):
    """gemma-2b's head dim: the decode and prefill plain versions against
    the reference oracles, fp32 on both sides."""
    rng = np.random.default_rng(7)
    B, T, H, Kv, hd, bs, MB = 2, 6, 4, 1, 256, 8, 4
    NB = 1 + B * MB
    kp, vp, ks, vs = _pools(rng, NB, bs, Kv, hd, int8)
    bt = _tables(rng, B, MB, NB)
    lens = np.asarray([3, 20], np.int32)
    sc = {} if not int8 else {"k_scale": ks, "v_scale": vs}
    tsc = {k: _t(v) for k, v in sc.items()}
    jsc = {k: _j(v) for k, v in sc.items()}
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    y = ref.paged_attention_ref(_t(q), _t(kp), _t(vp), _t(bt), _t(lens),
                                **tsc)
    yr = jref.paged_attention_ref(_j(q), _j(kp), _j(vp), _j(bt), _j(lens),
                                  **jsc)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=F32_TOL)
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    y = ref.paged_prefill_attention_ref(_t(q), _t(kp), _t(vp), _t(bt),
                                        _t(lens), **tsc)
    yr = jref.paged_prefill_attention_ref(_j(q), _j(kp), _j(vp), _j(bt),
                                          _j(lens), **jsc)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=F32_TOL)
