"""Card-only tests of the port: each CUDA kernel against its plain version,
and one serving step through the ``"cuda"`` backend.

They carry the ``cuda`` marker and skip where ``torch.cuda.is_available()``
is False.  This file imports neither JAX nor the reference package, so on a
machine with a card and no JAX it runs alone:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import ref
from repro_torch.kernels.batched_lora import batched_lora_matmul
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.paged_prefill import paged_prefill_attention
from repro_torch.kernels.quant import quantize_int8

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _bf16_tol(ref_out):
    # both sides compute in fp32 from the same inputs and round once to
    # bf16, in another summation order: two roundings of the largest value
    return float(ref_out.float().abs().max()) * 2.0 ** -7 + 1e-5


def _randn(gen, shape, dev, dtype=torch.float32, std=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("H,Kv", [(32, 32), (32, 8)])
def test_paged_kernels_match_plain(dev, H, Kv, int8):
    gen = torch.Generator(device=dev).manual_seed(0)
    B, T, hd, bs, MB = 4, 8, 128, 16, 6
    NB = 1 + B * MB
    kf = _randn(gen, (NB, bs, Kv, hd), dev)
    vf = _randn(gen, (NB, bs, Kv, hd), dev)
    if int8:
        kp, ks = quantize_int8(kf, -1)
        vp, vs = quantize_int8(vf, -1)
        sc = {"k_scale": ks, "v_scale": vs}
    else:
        kp, vp, sc = kf.to(torch.bfloat16), vf.to(torch.bfloat16), {}
    bt = (torch.randperm(B * MB, generator=gen, device=dev) + 1).reshape(
        B, MB).to(torch.int32)
    lens = torch.tensor([0, 1, 33, 80], dtype=torch.int32, device=dev)
    kernels.reset_launch_counts()
    q = _randn(gen, (B, H, hd), dev, torch.bfloat16)
    y = paged_attention(q, kp, vp, bt, lens, **sc)
    yr = ref.paged_attention_ref(q, kp, vp, bt, lens, **sc)
    assert float((y.float() - yr.float()).abs().max()) <= _bf16_tol(yr)
    assert float(y[0].float().abs().max()) == 0.0      # empty row
    q4 = _randn(gen, (B, T, H, hd), dev, torch.bfloat16)
    y4 = paged_prefill_attention(q4, kp, vp, bt, lens, **sc)
    yr4 = ref.paged_prefill_attention_ref(q4, kp, vp, bt, lens, **sc)
    assert float((y4.float() - yr4.float()).abs().max()) <= _bf16_tol(yr4)
    # fp32 queries: fp32 output, tight
    q32 = q.float()
    y32 = paged_attention(q32, kp, vp, bt, lens, **sc)
    yr32 = ref.paged_attention_ref(q32, kp, vp, bt, lens, **sc)
    torch.testing.assert_close(y32, yr32, atol=2e-5, rtol=1e-5)
    assert kernels.launch_counts() == {"paged_attention": 2,
                                       "paged_prefill_attention": 1,
                                       "batched_lora_matmul": 0}


@pytest.mark.parametrize("variant", ["f32_bank", "rank_mask", "int8_bank"])
def test_batched_lora_matches_plain(dev, variant):
    gen = torch.Generator(device=dev).manual_seed(1)
    M, K, N, C, r = 70, 256, 200, 4, 16
    x = _randn(gen, (M, K), dev, torch.bfloat16)
    w = _randn(gen, (K, N), dev, torch.bfloat16, 0.05)
    a = _randn(gen, (C, K, r), dev, std=0.05)
    b = _randn(gen, (C, r, N), dev, std=0.05)
    ids = torch.randint(0, C, (M,), generator=gen, device=dev,
                        dtype=torch.int32)
    kw = {}
    if variant == "rank_mask":
        kw["ranks"] = torch.tensor([3, 16, 1, 8], dtype=torch.int32,
                                   device=dev)
    if variant == "int8_bank":
        a, sa = quantize_int8(a, (1, 2))
        b, sb = quantize_int8(b, (1, 2))
        kw.update(a_scale=sa, b_scale=sb)
    y = batched_lora_matmul(x, w, a, b, ids, 2.0, **kw)
    yr = ref.batched_lora_matmul_ref(x, w, a, b, ids, 2.0, **kw)
    assert float((y.float() - yr.float()).abs().max()) <= _bf16_tol(yr)
    # fp32 activations and weights: the same function, tight
    y32 = batched_lora_matmul(x.float(), w.float(), a, b, ids, 2.0, **kw)
    yr32 = ref.batched_lora_matmul_ref(x.float(), w.float(), a, b, ids, 2.0,
                                       **kw)
    torch.testing.assert_close(y32, yr32, atol=1e-4, rtol=1e-4)


def test_kernels_refuse_what_they_do_not_take(dev):
    q = torch.zeros((2, 4, 16), device=dev)
    pool = torch.zeros((5, 4, 2, 16), device=dev)          # fp32 pool
    bt = torch.zeros((2, 2), dtype=torch.int32, device=dev)
    lens = torch.zeros((2,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="k_pool"):
        paged_attention(q, pool, pool, bt, lens)
    with pytest.raises(ValueError, match="rank"):
        batched_lora_matmul(torch.zeros((3, 8), device=dev),
                            torch.zeros((8, 5), device=dev),
                            torch.zeros((2, 8, 200), device=dev),
                            torch.zeros((2, 200, 5), device=dev),
                            torch.zeros((3,), dtype=torch.int32, device=dev))


def test_smoke_engine_serves_through_the_kernels(dev):
    """A few requests on the smoke config through the "cuda" backend: every
    kernel launches, and each request's first greedy token matches the
    "torch" backend's (fp32 activations, two layers: the paths differ by
    summation order only)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_engine, ragged_requests
    from repro_torch.serving.engine import ServeConfig
    cfg = get_config("llama2-7b", smoke=True).with_overrides(dtype="float32")
    eng = build_engine(cfg, 3, dev, seed=0, rank=8)
    reqs = ragged_requests(4, 3, cfg.vocab_size, 10, 40, seed=0)
    sc = ServeConfig(batch_size=3, max_new_tokens=5, prefill_chunk=16,
                     block_size=4, num_blocks=20)
    kernels.reset_launch_counts()
    out = eng.generate(reqs, sc)
    assert all(n > 0 for n in kernels.launch_counts().values())
    assert [len(o) for o in out] == [5] * 4
    ref_out = eng.generate(reqs, dataclasses.replace(sc,
                                                     paged_backend="torch"))
    assert [o[0] for o in out] == [o[0] for o in ref_out]
