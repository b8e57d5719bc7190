"""The port's kernel modules against the reference package on the CPU.

Each plain version (``repro_torch.kernels.ref``) is held against the
reference oracle of the same name (``repro.kernels.ref``) and against the
Pallas kernel run in interpret mode, on the same numpy inputs.  On CPU
tensors the wrappers run the plain version and launch nothing.  The
card-only tests are in ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.batched_lora import batched_lora_matmul as j_batched_lora
from repro.kernels.paged_prefill import paged_scatter as j_scatter
from repro.kernels.paged_prefill import paged_scatter_quant as j_scatter_quant
from repro.kernels.quant import quantize_int8 as j_quantize
from repro_torch import kernels
from repro_torch.kernels import ops, ref
from repro_torch.kernels.batched_lora import batched_lora_matmul
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.paged_prefill import (paged_prefill_attention,
                                               paged_scatter,
                                               paged_scatter_quant)
from repro_torch.kernels.quant import dequantize_int8, quantize_int8

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
