"""The training path's kernel modules against the reference on the CPU.

``lora_matmul``, ``dual_lora_matmul`` and ``flash_attention`` (and their
``ops`` wrappers) run their plain versions on CPU tensors.  Each is held
against the reference oracle of the same name (``repro.kernels.ref``) and
against the Pallas kernel run in interpret mode, on the same numpy inputs,
at tile-aligned shapes.  The backward of the LoRA kernel's autograd
function is plain PyTorch and is held here against autograd of the plain
version and against ``jax.vjp`` of the reference oracle.  The card-only
checks are in ``test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.dual_lora import dual_lora_matmul as j_dual_lora
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.lora_matmul import lora_matmul as j_lora_matmul
from repro_torch import kernels
from repro_torch.kernels import ops, ref
from repro_torch.kernels.dual_lora import dual_lora_matmul
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.lora_matmul import lora_matmul, lora_matmul_backward

# fp32 on both sides, the same inputs: only summation order differs
F32_TOL = 1e-4
# the Pallas LoRA kernels round z and the B factors to the input type
# before their last dot (the port and its oracle keep fp32): in bf16 that
# is the reference test's own bound (tests/test_kernels.py)
BF16_PALLAS_TOL = 0.08


def _np(t):
    return np.asarray(t, np.float32)


def _tn(a):
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _lora_inputs(seed, M=256, K=256, N=256, r=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    a = (rng.standard_normal((K, r)) * 0.05).astype(np.float32)
    b = (rng.standard_normal((r, N)) * 0.05).astype(np.float32)
    return x, w, a, b


def test_lora_matmul_matches_reference_and_pallas():
    x, w, a, b = _lora_inputs(0)
    y = lora_matmul(_tn(x), _tn(w), _tn(a), _tn(b), 2.0)
    assert y.dtype == torch.float32 and y.shape == (256, 256)
    yr = jref.lora_matmul_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(a),
                              jnp.asarray(b), 2.0)
    yk = j_lora_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(a),
                       jnp.asarray(b), scale=2.0, bm=128, bn=128, bk=128)
    np.testing.assert_allclose(y.numpy(), _np(yr), atol=F32_TOL)
    np.testing.assert_allclose(y.numpy(), _np(yk), atol=F32_TOL)
    # bf16 activations and weights, fp32 factors: the port and the oracle
    # both round once from fp32 (one bf16 ulp apart at most)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    yb = lora_matmul(_tn(_np(xb)).bfloat16(), _tn(_np(wb)).bfloat16(),
                     _tn(a), _tn(b), 2.0)
    assert yb.dtype == torch.bfloat16
    ybr = _np(jref.lora_matmul_ref(xb, wb, jnp.asarray(a), jnp.asarray(b),
                                   2.0))
    np.testing.assert_allclose(yb.float().numpy(), ybr,
                               atol=np.abs(ybr).max() * 2.0 ** -7)
    ybk = _np(j_lora_matmul(xb, wb, jnp.asarray(a), jnp.asarray(b), scale=2.0,
                            bm=128, bn=128, bk=128))
    np.testing.assert_allclose(yb.float().numpy(), ybk, atol=BF16_PALLAS_TOL)


def test_lora_matmul_backward_matches_autograd_and_jax_vjp():
    """The kernel's plain backward (reusing z = x·A) gives the gradients of
    the plain version in x, A and B, and those of the reference oracle."""
    x, w, a, b = _lora_inputs(1, M=64, K=96, N=80, r=8)
    dy = np.random.default_rng(2).standard_normal((64, 80)).astype(np.float32)
    xt, at, bt = (_tn(v).requires_grad_(True) for v in (x, a, b))
    ref.lora_matmul_ref(xt, _tn(w), at, bt, 2.0).backward(_tn(dy))
    z = _tn(x) @ _tn(a)
    dx, da, db = lora_matmul_backward(_tn(x), _tn(w), _tn(a), _tn(b), z,
                                      _tn(dy), 2.0)
    for got, want in ((dx, xt.grad), (da, at.grad), (db, bt.grad)):
        torch.testing.assert_close(got, want, atol=F32_TOL, rtol=1e-5)
    _, vjp = jax.vjp(lambda x_, a_, b_: jref.lora_matmul_ref(
        x_, jnp.asarray(w), a_, b_, 2.0), jnp.asarray(x), jnp.asarray(a),
        jnp.asarray(b))
    for got, want in zip((dx, da, db), vjp(jnp.asarray(dy))):
        np.testing.assert_allclose(got.numpy(), _np(want), atol=F32_TOL)
    # only what is asked for is computed
    assert lora_matmul_backward(_tn(x), _tn(w), _tn(a), _tn(b), z, _tn(dy),
                                2.0, (False, True, False))[0::2] == (None,
                                                                     None)


@pytest.mark.parametrize("fw", [(0.8, 0.3), (1.0, 0.0)])
def test_dual_lora_matmul_matches_reference_and_pallas(fw):
    rng = np.random.default_rng(3)
    M = K = N = 256
    r = 8
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    a1, a2 = ((rng.standard_normal((K, r)) * 0.05).astype(np.float32)
              for _ in range(2))
    b1, b2 = ((rng.standard_normal((r, N)) * 0.05).astype(np.float32)
              for _ in range(2))
    fwn = np.asarray(fw, np.float32)
    y = dual_lora_matmul(*(_tn(v) for v in (x, w, a1, b1, a2, b2, fwn)), 2.0)
    j = [jnp.asarray(v) for v in (x, w, a1, b1, a2, b2)]
    yr = jref.dual_lora_matmul_ref(*j, fwn[0], fwn[1], 2.0)
    yk = j_dual_lora(*j, jnp.asarray(fwn), scale=2.0, bm=128, bn=128, bk=128)
    np.testing.assert_allclose(y.numpy(), _np(yr), atol=F32_TOL)
    np.testing.assert_allclose(y.numpy(), _np(yk), atol=F32_TOL)
    if fw == (1.0, 0.0):      # Eq. 7 at w = (1, 0) is the personal pair alone
        ys = lora_matmul(_tn(x), _tn(w), _tn(a1), _tn(b1), 2.0)
        torch.testing.assert_close(y, ys, atol=F32_TOL, rtol=1e-5)
    # bf16 activations: one rounding on each side
    xb = jnp.asarray(x, jnp.bfloat16)
    wb = jnp.asarray(w, jnp.bfloat16)
    yb = dual_lora_matmul(_tn(_np(xb)).bfloat16(), _tn(_np(wb)).bfloat16(),
                          *(_tn(v) for v in (a1, b1, a2, b2, fwn)), 2.0)
    ybk = _np(j_dual_lora(xb, wb, *j[2:], jnp.asarray(fwn), scale=2.0,
                          bm=128, bn=128, bk=128))
    np.testing.assert_allclose(yb.float().numpy(), ybk, atol=BF16_PALLAS_TOL)


@pytest.mark.parametrize("B,H,Sq,Sk,d,window", [
    (2, 2, 256, 256, 32, 0),      # training: causal, Sq == Sk
    (1, 2, 256, 256, 32, 64),     # sliding window
    (1, 2, 128, 384, 32, 0),      # Sq < Sk: positions aligned at the end
])
def test_flash_attention_matches_reference_and_pallas(B, H, Sq, Sk, d,
                                                      window):
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((B, H, S, d)).astype(np.float32)
               for S in (Sq, Sk, Sk))
    o = flash_attention(_tn(q), _tn(k), _tn(v), causal=True,
                        sliding_window=window)
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    orf = jref.flash_attention_ref(jq, jk, jv, causal=True,
                                   sliding_window=window)
    ok = j_flash(jq, jk, jv, causal=True, sliding_window=window)
    np.testing.assert_allclose(o.numpy(), _np(orf), atol=F32_TOL)
    np.testing.assert_allclose(o.numpy(), _np(ok), atol=F32_TOL)


@pytest.mark.parametrize("B,H,Sq,Sk", [
    (2, 2, 128, 128),     # an encoder's self-attention: Sq == Sk
    (1, 2, 128, 384),     # cross-attention in training: Sq < Sk
    (2, 2, 1, 256),       # cross-attention in decode: one query
    (1, 2, 256, 128),     # Sq > Sk: every query still attends every key
])
def test_non_causal_flash_attention_matches_reference_and_pallas(B, H, Sq,
                                                                 Sk):
    """``causal=False`` at head dim 64 (whisper's): no mask at all, so the
    positions' end alignment plays no part."""
    rng = np.random.default_rng(7)
    d = 64
    q, k, v = (rng.standard_normal((B, H, S, d)).astype(np.float32)
               for S in (Sq, Sk, Sk))
    o = flash_attention(_tn(q), _tn(k), _tn(v), causal=False)
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    orf = jref.flash_attention_ref(jq, jk, jv, causal=False)
    ok = j_flash(jq, jk, jv, causal=False)
    assert o.shape == (B, H, Sq, d)
    np.testing.assert_allclose(o.numpy(), _np(orf), atol=F32_TOL)
    np.testing.assert_allclose(o.numpy(), _np(ok), atol=F32_TOL)


def test_gqa_flash_attention_matches_reference_wrapper():
    """Model layout (B, S, H, d) with Kv < H: the port's plain path repeats
    kv heads as the reference wrapper does; the same numbers come out."""
    rng = np.random.default_rng(5)
    B, S, H, Kv, d = 1, 128, 4, 2, 32
    q = rng.standard_normal((B, S, H, d)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, Kv, d)).astype(np.float32)
            for _ in range(2))
    o = ops.gqa_flash_attention(_tn(q), _tn(k), _tn(v), causal=True)
    oj = jops.gqa_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True)
    assert o.shape == (B, S, H, d)
    np.testing.assert_allclose(o.numpy(), _np(oj), atol=F32_TOL)


def test_ops_dense_wrappers_match_reference_wrappers():
    """``lora_dense`` / ``fused_dual_lora_dense`` on (B, S, K) activations
    against the reference wrappers, which pad to their tiles and run the
    Pallas kernels on bf16 activations."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 10, 200)).astype(np.float32)
    w = (rng.standard_normal((200, 300)) * 0.05).astype(np.float32)
    ad = {k: (rng.standard_normal(s) * 0.05).astype(np.float32)
          for k, s in (("a", (200, 4)), ("b", (4, 300)))}
    ad2 = {k: (rng.standard_normal(v.shape) * 0.05).astype(np.float32)
           for k, v in ad.items()}
    fw = np.asarray([0.6, 0.7], np.float32)
    xb = _np(jnp.asarray(x, jnp.bfloat16))
    tad = {k: _tn(v) for k, v in ad.items()}
    tad2 = {k: _tn(v) for k, v in ad2.items()}
    y = ops.lora_dense(_tn(xb).bfloat16(), _tn(w), tad, 2.0)
    yj = jops.lora_dense(jnp.asarray(x), jnp.asarray(w),
                         {k: jnp.asarray(v) for k, v in ad.items()}, 2.0,
                         block=128)
    assert y.shape == (2, 10, 300)
    np.testing.assert_allclose(y.float().numpy(), _np(yj),
                               atol=BF16_PALLAS_TOL)
    yd = ops.fused_dual_lora_dense(_tn(xb).bfloat16(), _tn(w), tad, tad2,
                                   _tn(fw), 2.0)
    ydj = jops.fused_dual_lora_dense(
        jnp.asarray(x), jnp.asarray(w),
        {k: jnp.asarray(v) for k, v in ad.items()},
        {k: jnp.asarray(v) for k, v in ad2.items()}, jnp.asarray(fw), 2.0,
        block=128)
    np.testing.assert_allclose(yd.float().numpy(), _np(ydj),
                               atol=BF16_PALLAS_TOL)


def test_training_wrappers_run_plain_version_on_cpu_and_launch_nothing():
    rng = np.random.default_rng(7)
    kernels.reset_launch_counts()
    x, w, a, b = (_tn(v) for v in _lora_inputs(8, M=6, K=8, N=5, r=3))
    np.testing.assert_array_equal(lora_matmul(x, w, a, b, 2.0).numpy(),
                                  ref.lora_matmul_ref(x, w, a, b, 2.0).numpy())
    fw = torch.tensor([0.4, 0.9])
    np.testing.assert_array_equal(
        dual_lora_matmul(x, w, a, b, 2 * a, b, fw, 2.0).numpy(),
        ref.dual_lora_matmul_ref(x, w, a, b, 2 * a, b, fw[0], fw[1],
                                 2.0).numpy())
    q = _tn(rng.standard_normal((1, 4, 5, 8)))
    kv = _tn(rng.standard_normal((1, 2, 7, 8)))
    np.testing.assert_array_equal(
        flash_attention(q, kv, kv, sliding_window=3).numpy(),
        ref.flash_attention_ref(q, kv, kv, sliding_window=3).numpy())
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)


def test_training_wrappers_reject_bad_shapes():
    z = torch.zeros
    with pytest.raises(ValueError):
        lora_matmul(z((3, 8)), z((7, 5)), z((8, 2)), z((2, 5)))
    with pytest.raises(ValueError):
        dual_lora_matmul(z((3, 8)), z((8, 5)), z((8, 2)), z((2, 5)),
                         z((8, 3)), z((2, 5)), z(2))
    with pytest.raises(ValueError):                  # 3 query heads, 2 kv
        flash_attention(z((1, 3, 4, 8)), z((1, 2, 4, 8)), z((1, 2, 4, 8)))
    with pytest.raises(ValueError, match="no key"):  # causal, Sq > Sk
        flash_attention(z((1, 2, 6, 8)), z((1, 2, 4, 8)), z((1, 2, 4, 8)))
