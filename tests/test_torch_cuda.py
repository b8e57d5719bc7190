"""Card-only tests of the port: each CUDA kernel against its plain version
(the split-K decode kernel at GQA groups 1 to 12, head dims 32 to 256,
blocks of 8 to 32, bf16 and int8 pools and fp32 and bf16 queries over
contexts of 0 to 4 splits + 3, with bitwise repeatability, row isolation,
its refusals and its launch counts, and under sliding windows of 1 to
4096 over contexts to 6144; the two other attention kernels through both
their tiles: the tensor-core tile for bf16 at head dims 32, 64, 128 and
256 over ragged, poisoned and misaligned inputs, the paged prefill kernel
also under sliding windows, each row also held to the tile's own
arithmetic, the fp32 tile held tight; the cuda paged branch of the model
through a window, refusing a logit softcap; the four LoRA kernels through
both their tiles at edge shapes under every launch plan, with split-K held
bitwise stable, the dual kernels at ranks 1 to 128 with rows outside the
bank and negative fusion weights, bf16 rows held to the tile model, and
the four LoRA libraries loaded together in one process), the two autograd
backwards against plain autograd, serving runs (each dense arch's smoke
config, and with int8 K/V, a ragged int8 bank, prefix caching and
speculative decoding), overlapped dispatch (streams with overlap on and off bitwise
equal, greedy and sampled; no round of ``StreamSession.step`` waits for
the stream, checked under ``torch.cuda.set_sync_debug_mode("error")``),
sharded serving (2 shards bitwise equal to one pool, fp32 and int8 K/V
with a ragged int8 bank; the sharded round loop with a hot-swap under the
sync debug mode), the fixed-batch path and the single-tenant ``Engine``
through the LoRA kernels (``lora_matmul`` also at decode rows, M 1 to 64),
``launch/serve.py`` with those options, one ``launch/train.py --smoke``
run through the ``"cuda"`` backend, and the federated baselines
(``lora_matmul`` at ranks 2 to 32, every baseline's fit through the
kernels, FedProx, FedRoD and FedKD steps against the plain path, the
client-stacked round step against the clients run by hand), and the MoE
family (decode and prefill at dbrx-132b's G 6, batched LoRA at the MoE
archs' attention projections, ``apply_moe`` bitwise repeatable, each MoE
smoke config served through the kernels, overlap on and off bitwise, and
a prefill chunk "cuda" against "torch" with pinned routing), and the SSM
and hybrid families (batched LoRA at the in_proj shapes whose N runs past
a multiple of 256, mamba2-smoke and jamba-smoke served through the
kernels with overlap on and off bitwise, mamba2-smoke "cuda" against
"torch", its rounds without a wait for the stream), and full fine-tuning
(the expert products' weight gradient; every family's smoke config
through flash attention and no LoRA kernel, "cuda" against "torch").

They carry the ``cuda`` marker and skip where ``torch.cuda.is_available()``
is False.  This file imports neither JAX nor the reference package, so on a
machine with a card and no JAX it runs alone:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import attn_tile, ref
from repro_torch.kernels.batched_lora import (batched_dual_lora_matmul,
                                              batched_lora_matmul)
from repro_torch.kernels.paged_attention import SPLIT, paged_attention
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


def _attn_tol(ref_out, v):
    # the bf16 attention tile rounds P (or P·v_scale) to bf16 as its mma
    # operand, as the TPU kernel does, where the plain version keeps P in
    # fp32 (or rounds it normalised): each output is a convex sum of v, so
    # that adds one bf16 rounding of the largest |v| (dequantized)
    return _bf16_tol(ref_out) + float(v.float().abs().max()) * 2.0 ** -8


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
    assert float((y4.float() - yr4.float()).abs().max()) <= _attn_tol(
        yr4, vp.float() * sc["v_scale"][..., None] if int8 else vp)
    # fp32 queries: fp32 output, tight
    q32 = q.float()
    y32 = paged_attention(q32, kp, vp, bt, lens, **sc)
    yr32 = ref.paged_attention_ref(q32, kp, vp, bt, lens, **sc)
    torch.testing.assert_close(y32, yr32, atol=2e-5, rtol=1e-5)
    assert kernels.launch_counts() == dict(
        dict.fromkeys(kernels.WRAPPERS, 0), paged_attention=2,
        paged_prefill_attention=1)
    assert kernels.tile_counts()["paged_prefill_attention"] == {"mma": 1,
                                                                "f32": 0}


# ---------------------------------------------------------------------------
# decode: the split-K kernel
# ---------------------------------------------------------------------------

def _decode_case(gen, dev, G, hd, bs, int8, lengths, Kv=2, MB=None):
    """Pools, disjoint tables, lengths and bf16 queries for one decode
    call; returns (q, kp, vp, bt, lens, scales)."""
    B = len(lengths)
    MB = MB or max(1, -(-max(lengths) // bs))
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
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q = _randn(gen, (B, G * Kv, hd), dev, torch.bfloat16)
    return q, kp, vp, bt, lens, sc


# contexts around the split boundaries, up to 4 splits + 3, one empty row
DECODE_LENGTHS = [0, 1, 7, SPLIT - 1, SPLIT, SPLIT + 1, 2 * SPLIT + 9,
                  4 * SPLIT + 3]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("bs", [8, 16, 32])
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("G", [1, 2, 4, 8, 12])
def test_paged_decode_split_matches_plain(dev, G, hd, bs, int8):
    gen = torch.Generator(device=dev).manual_seed(G * 1000 + hd + bs)
    q, kp, vp, bt, lens, sc = _decode_case(gen, dev, G, hd, bs, int8,
                                           DECODE_LENGTHS)
    y = paged_attention(q, kp, vp, bt, lens, **sc)
    yr = ref.paged_attention_ref(q, kp, vp, bt, lens, **sc)
    assert y.dtype == torch.bfloat16
    assert float((y.float() - yr.float()).abs().max()) <= _bf16_tol(yr)
    assert float(y[0].float().abs().max()) == 0.0      # empty row
    q32 = q.float()
    y32 = paged_attention(q32, kp, vp, bt, lens, **sc)
    yr32 = ref.paged_attention_ref(q32, kp, vp, bt, lens, **sc)
    torch.testing.assert_close(y32, yr32, atol=2e-5, rtol=1e-5)
    assert float(y32[0].abs().max()) == 0.0


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("G", [1, 4])
def test_paged_decode_split_is_bitwise_stable(dev, G, int8):
    """Three calls agree bitwise, and each row alone (its own table row, the
    same table width) equals that row inside the batch of 8."""
    gen = torch.Generator(device=dev).manual_seed(5)
    q, kp, vp, bt, lens, sc = _decode_case(gen, dev, G, 128, 16, int8,
                                           DECODE_LENGTHS)
    ys = [paged_attention(q, kp, vp, bt, lens, **sc) for _ in range(3)]
    assert all(torch.equal(ys[0], y) for y in ys[1:])
    for b in range(len(DECODE_LENGTHS)):
        alone = paged_attention(q[b:b + 1].contiguous(), kp, vp,
                                bt[b:b + 1].contiguous(),
                                lens[b:b + 1].contiguous(), **sc)
        assert torch.equal(alone[0], ys[0][b]), b
    # a wider table adds splits past every row's end: nothing changes
    wide = torch.cat([bt, bt[:, :9]], dim=1).contiguous()
    assert torch.equal(paged_attention(q, kp, vp, wide, lens, **sc), ys[0])


def test_paged_decode_split_launch_counts(dev):
    """One launch while the table spans one split, two past it."""
    gen = torch.Generator(device=dev).manual_seed(6)
    for MB, want_split, want_combine in ((SPLIT // 16, 1, 0),
                                         (SPLIT // 16 + 1, 2, 1)):
        q, kp, vp, bt, lens, sc = _decode_case(gen, dev, 1, 128, 16, False,
                                               [0, 5, MB * 16], MB=MB)
        kernels.reset_launch_counts()
        y = paged_attention(q, kp, vp, bt, lens)
        yr = ref.paged_attention_ref(q, kp, vp, bt, lens)
        assert float((y.float() - yr.float()).abs().max()) <= _bf16_tol(yr)
        f = paged_attention
        assert (f.launches, f.launches_split, f.launches_combine) == (
            1, want_split, want_combine)


# windows around the split length (128) and starcoder2's 4096
WINDOWS = [1, 16, 127, 128, 129, 4096]
# contexts on both sides of split boundaries and of the 4096 window, up to
# 48 splits (6144: whole splits below the window drop out)
WINDOW_LENGTHS = [0, 1, 7, SPLIT - 1, SPLIT, SPLIT + 1, 2 * SPLIT + 9, 4095,
                  4096, 4097, 4 * 1024 + 3 * SPLIT + 5, 6144]


@pytest.mark.parametrize("W", WINDOWS)
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("G", [1, 12])
def test_paged_decode_window_matches_plain(dev, G, int8, W):
    """A sliding window (starcoder2's, and windows one position either side
    of a split): bf16 and fp32 queries against the plain version with the
    same window, and the window binds."""
    gen = torch.Generator(device=dev).manual_seed(40 + W + G)
    q, kp, vp, bt, lens, sc = _decode_case(gen, dev, G, 128, 16, int8,
                                           WINDOW_LENGTHS)
    kernels.reset_launch_counts()
    y = paged_attention(q, kp, vp, bt, lens, sliding_window=W, **sc)
    yr = ref.paged_attention_ref(q, kp, vp, bt, lens, sliding_window=W, **sc)
    assert float((y.float() - yr.float()).abs().max()) <= _bf16_tol(yr)
    assert float(y[0].float().abs().max()) == 0.0      # empty row
    f = paged_attention
    assert (f.launches, f.launches_combine) == (1, 1)
    full = ref.paged_attention_ref(q, kp, vp, bt, lens, **sc)
    assert float((full[-1].float() - yr[-1].float()).abs().max()) > 1e-2
    q32 = q.float()
    y32 = paged_attention(q32, kp, vp, bt, lens, sliding_window=W, **sc)
    yr32 = ref.paged_attention_ref(q32, kp, vp, bt, lens, sliding_window=W,
                                   **sc)
    torch.testing.assert_close(y32, yr32, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("W", [1, 128, 129, 4096])
def test_paged_decode_window_rows_are_bitwise_independent(dev, W):
    """With a window, three calls agree bitwise; each row alone equals that
    row in the batch; a wider table changes nothing."""
    gen = torch.Generator(device=dev).manual_seed(50 + W)
    q, kp, vp, bt, lens, sc = _decode_case(gen, dev, 4, 128, 16, False,
                                           WINDOW_LENGTHS)
    kw = {"sliding_window": W, **sc}
    ys = [paged_attention(q, kp, vp, bt, lens, **kw) for _ in range(3)]
    assert all(torch.equal(ys[0], y) for y in ys[1:])
    for b in range(len(WINDOW_LENGTHS)):
        alone = paged_attention(q[b:b + 1].contiguous(), kp, vp,
                                bt[b:b + 1].contiguous(),
                                lens[b:b + 1].contiguous(), **kw)
        assert torch.equal(alone[0], ys[0][b]), b
    wide = torch.cat([bt, bt[:, :9]], dim=1).contiguous()
    assert torch.equal(paged_attention(q, kp, vp, wide, lens, **kw), ys[0])


@pytest.mark.parametrize("W", WINDOWS)
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("G", [1, 8, 12])
def test_paged_prefill_window_matches_plain(dev, G, int8, W):
    """A 256-token chunk behind contexts up to 4352 (the window binds in
    every row past it) through both tiles with a sliding window: bf16
    against the plain version and, per row, the tile's own arithmetic;
    fp32 tight."""
    gen = torch.Generator(device=dev).manual_seed(60 + W + G)
    T, bs, hd = 256, 16, 128
    q, kp, vp, sc, vdq, bt, lens = _prefill_case(
        gen, dev, T, G, bs, hd, int8, [0, 5, 130, 4096], H=4 * G)
    kw = {"sliding_window": W, **sc}
    kernels.reset_launch_counts()
    y = paged_prefill_attention(q, kp, vp, bt, lens, **kw)
    yr = ref.paged_prefill_attention_ref(q, kp, vp, bt, lens, **kw)
    assert bool(torch.isfinite(y.float()).all())
    assert float((y.float() - yr.float()).abs().max()) <= _attn_tol(yr, vdq)
    _, ratio = attn_tile.tile_errors(y, attn_tile.paged_prefill_tile_ref(
        q, kp, vp, bt, lens, **kw))
    assert ratio <= 1.0
    if W < 4096:
        full = ref.paged_prefill_attention_ref(q, kp, vp, bt, lens, **sc)
        assert float((full.float() - yr.float()).abs().max()) > 1e-2
    y32 = paged_prefill_attention(q.float(), kp, vp, bt, lens, **kw)
    yr32 = ref.paged_prefill_attention_ref(q.float(), kp, vp, bt, lens, **kw)
    torch.testing.assert_close(y32, yr32, atol=2e-5, rtol=1e-5)
    assert kernels.tile_counts()["paged_prefill_attention"] == {"mma": 1,
                                                                "f32": 1}


def test_cuda_paged_branch_takes_a_window_and_refuses_softcap(dev):
    """starcoder2-smoke (window 16) decodes through the "cuda" paged branch
    past its window and matches the "torch" branch; a logit softcap is
    still refused."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import Model
    cfg = get_config("starcoder2-15b", smoke=True).with_overrides(
        dtype="float32")
    model = Model(cfg, dev)
    params = model.init(0)
    bt = torch.arange(1, 9, dtype=torch.int32, device=dev)[None]
    toks = torch.randint(0, cfg.vocab_size, (1, 40), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    out = {}
    for backend in ("cuda", "torch"):
        cache = model.init_paged_decode_cache(9, 8)
        kernels.reset_launch_counts()
        logits, cache = model.prefill_step(
            params, cache, toks[:, :32], torch.tensor([0], device=dev),
            torch.tensor([32], device=dev), block_tables=bt,
            paged_backend=backend)
        steps = [logits[0, -1]]
        for i in range(32, 40):
            lg, cache = model.decode_step(
                params, cache, toks[:, i:i + 1], torch.tensor([i], device=dev),
                block_tables=bt, paged_backend=backend)
            steps.append(lg[0, -1])
        out[backend] = (torch.stack(steps), kernels.launch_counts())
    (lc, nc), (lt, _) = out["cuda"], out["torch"]
    assert nc["paged_attention"] == 8 * cfg.n_layers
    assert nc["paged_prefill_attention"] == cfg.n_layers
    torch.testing.assert_close(lc, lt, atol=1e-4, rtol=1e-4)
    soft = Model(cfg.with_overrides(attn_logit_softcap=30.0), dev)
    with pytest.raises(NotImplementedError, match="softcap"):
        soft.decode_step(params, model.init_paged_decode_cache(9, 8),
                         toks[:, :1], torch.tensor([0], device=dev),
                         block_tables=bt, paged_backend="cuda")


def test_paged_decode_split_refuses_what_it_does_not_take(dev):
    z = torch.zeros
    bf = torch.bfloat16
    bt = z((2, 2), dtype=torch.int32, device=dev)
    lens = z((2,), dtype=torch.int32, device=dev)
    for hd in (36, 48):                     # not a multiple of 8; not built
        pool = z((5, 4, 2, hd), dtype=bf, device=dev)
        with pytest.raises(ValueError, match="head dim"):
            paged_attention(z((2, 4, hd), dtype=bf, device=dev), pool, pool,
                            bt, lens)
    flat = z(5 * 4 * 2 * 64 + 1, dtype=bf, device=dev)
    pool = flat[1:].view(5, 4, 2, 64)       # contiguous, 2 bytes off
    with pytest.raises(ValueError, match="aligned"):
        paged_attention(z((2, 4, 64), dtype=bf, device=dev), pool, pool, bt,
                        lens)


def _prefill_case(gen, dev, T, G, bs, hd, int8, lengths, H=None):
    """Pools, tables and bf16 queries for a prefill call.  The table width
    MB is one block short of the longest row's chunk end, so that row's
    chunk tail runs past its table (ragged tail)."""
    H = H or 2 * G
    Kv = H // G
    B = len(lengths)
    MB = max(1, -(-(max(lengths) + T) // bs) - 1)
    NB = 1 + B * MB + 3                    # 3 blocks no table points at
    kf = _randn(gen, (NB, bs, Kv, hd), dev)
    vf = _randn(gen, (NB, bs, Kv, hd), dev)
    if int8:
        kp, ks = quantize_int8(kf, -1)
        vp, vs = quantize_int8(vf, -1)
        sc = {"k_scale": ks, "v_scale": vs}
        vdq = vp.float() * vs[..., None]
    else:
        kp, vp, sc = kf.to(torch.bfloat16), vf.to(torch.bfloat16), {}
        vdq = vp
    bt = (torch.randperm(B * MB, generator=gen, device=dev) + 1).reshape(
        B, MB).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q = _randn(gen, (B, T, H, hd), dev, torch.bfloat16)
    return q, kp, vp, sc, vdq, bt, lens


# (T, G, bs, hd): T not a multiple of 64; G = 4 with folded rows crossing
# a 64-row tile edge (T = 20: rows 60-67 hold t = 15, 16); blocks of 16
# and 32; head dims 32, 64, 128 and 256 (gemma-2b: G 8 over one kv head)
PREFILL_CASES = [(1, 1, 16, 128), (8, 1, 16, 128), (100, 1, 16, 128),
                 (256, 1, 16, 128), (20, 4, 16, 128), (100, 4, 32, 64),
                 (8, 1, 32, 32), (100, 2, 16, 32), (256, 4, 32, 64),
                 (20, 1, 16, 256), (100, 8, 16, 256), (256, 8, 32, 256)]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("T,G,bs,hd", PREFILL_CASES)
def test_prefill_tiles_match_plain(dev, T, G, bs, hd, int8):
    """Rows: an empty context, chunks starting mid-block, and one whose
    chunk tail runs past its table."""
    gen = torch.Generator(device=dev).manual_seed(10 + hd + T)
    lengths = [0, 5, 37, 130]
    q, kp, vp, sc, vdq, bt, lens = _prefill_case(
        gen, dev, T, G, bs, hd, int8, lengths, H=G if hd == 256 else None)
    kernels.reset_launch_counts()
    y = paged_prefill_attention(q, kp, vp, bt, lens, **sc)
    yr = ref.paged_prefill_attention_ref(q, kp, vp, bt, lens, **sc)
    assert bool(torch.isfinite(y.float()).all())
    assert float((y.float() - yr.float()).abs().max()) <= _attn_tol(yr, vdq)
    # every row within two bf16 ulps of the tile's own arithmetic
    _, ratio = attn_tile.tile_errors(y, attn_tile.paged_prefill_tile_ref(
        q, kp, vp, bt, lens, **sc))
    assert ratio <= 1.0
    # fp32 queries: the fp32 tile, tight
    y32 = paged_prefill_attention(q.float(), kp, vp, bt, lens, **sc)
    yr32 = ref.paged_prefill_attention_ref(q.float(), kp, vp, bt, lens, **sc)
    torch.testing.assert_close(y32, yr32, atol=2e-5, rtol=1e-5)
    assert kernels.tile_counts()["paged_prefill_attention"] == {"mma": 1,
                                                                "f32": 1}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("int8", [False, True])
def test_prefill_ignores_pool_slots_past_the_last_query(dev, int8, dtype):
    """NaN in every block no table points at and at every position >=
    lengths[b] + T of each row's blocks (int8 pools: in the scales): the
    output is finite and equal to the clean pool's."""
    gen = torch.Generator(device=dev).manual_seed(20)
    T, G, bs, hd = 100, 4, 16, 64
    q, kp, vp, sc, _, bt, lens = _prefill_case(gen, dev, T, G, bs, hd, int8,
                                               [0, 5, 37, 130])
    q = q.to(dtype)
    clean = paged_prefill_attention(q, kp, vp, bt, lens, **sc)
    pos = torch.arange(bs, device=dev)
    poison = torch.ones(kp.shape[:2], dtype=torch.bool, device=dev)
    for b in range(bt.shape[0]):
        for i, blk in enumerate(bt[b].tolist()):
            poison[blk] = i * bs + pos >= int(lens[b]) + T
    if int8:
        sc = {k: torch.where(poison[..., None], float("nan"), v)
              for k, v in sc.items()}
    else:
        kp, vp = (torch.where(poison[..., None, None],
                              torch.tensor(float("nan"), device=dev,
                                           dtype=t.dtype), t)
                  for t in (kp, vp))
    y = paged_prefill_attention(q, kp, vp, bt, lens, **sc)
    assert bool(torch.isfinite(y.float()).all())
    assert torch.equal(y, clean)


# (H, Kv, Sq, Sk, window, d, causal): window, Sq < Sk and GQA at head dims
# 32, 64, 128 and 256, non-causal cases with and without a window
FLASH_CASES = [(4, 4, 100, 100, 17, 32, True), (4, 1, 40, 130, 0, 32, True),
               (8, 2, 200, 300, 50, 64, True), (4, 4, 96, 96, 0, 64, False),
               (8, 2, 64, 64, 0, 128, True), (4, 4, 70, 250, 33, 128, True),
               (4, 2, 130, 130, 20, 128, False),
               (8, 1, 256, 256, 0, 256, True), (4, 1, 130, 130, 40, 256, True),
               (2, 2, 70, 200, 0, 256, False),
               # whisper-small's, non-causal at hd 64: cross-attention in
               # decode and in training, the encoder's self-attention
               (12, 12, 1, 1500, 0, 64, False),
               (12, 12, 256, 1500, 0, 64, False),
               (12, 12, 1500, 1500, 0, 64, False)]


@pytest.mark.parametrize("H,Kv,Sq,Sk,window,d,causal", FLASH_CASES)
def test_flash_tiles_match_plain(dev, H, Kv, Sq, Sk, window, d, causal):
    """Model-layout (B, S, heads, d) views, as the training forward passes
    them; bf16 through the tensor-core tile, fp32 through the fp32 tile,
    tight."""
    from repro_torch.kernels.flash_attention import flash_attention
    gen = torch.Generator(device=dev).manual_seed(30 + d)
    B = 2
    q = _randn(gen, (B, Sq, H, d), dev, torch.bfloat16).transpose(1, 2)
    k = _randn(gen, (B, Sk, Kv, d), dev, torch.bfloat16).transpose(1, 2)
    v = _randn(gen, (B, Sk, Kv, d), dev, torch.bfloat16).transpose(1, 2)
    kw = {"causal": causal, "sliding_window": window}
    kernels.reset_launch_counts()
    o = flash_attention(q, k, v, **kw)
    orf = ref.flash_attention_ref(q, k, v, **kw)
    assert float((o.float() - orf.float()).abs().max()) <= _attn_tol(orf, v)
    _, ratio = attn_tile.tile_errors(o, attn_tile.flash_attention_tile_ref(
        q, k, v, **kw))
    assert ratio <= 1.0
    o32 = flash_attention(q.float(), k.float(), v.float(), **kw)
    orf32 = ref.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    torch.testing.assert_close(o32, orf32, atol=2e-5, rtol=1e-5)
    assert kernels.tile_counts()["flash_attention"] == {"mma": 1, "f32": 1}


def test_attention_tiles_refuse_what_they_do_not_take(dev):
    from repro_torch.kernels.flash_attention import flash_attention
    z = torch.zeros
    bf = torch.bfloat16
    pool = z((5, 4, 2, 96), dtype=bf, device=dev)
    bt = z((2, 2), dtype=torch.int32, device=dev)
    lens = z((2,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head dims"):       # hd 96
        paged_prefill_attention(z((2, 3, 4, 96), dtype=bf, device=dev),
                                pool, pool, bt, lens)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(*(z((1, 2, 8, 48), dtype=bf, device=dev)
                          for _ in range(3)))
    # a contiguous q one element off 16-byte alignment
    pool = z((5, 4, 2, 64), dtype=bf, device=dev)
    flat = z(2 * 3 * 4 * 64 + 1, dtype=bf, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        paged_prefill_attention(flat[1:].view(2, 3, 4, 64), pool, pool, bt,
                                lens)
    # strided views: a pointer off alignment, then a row stride off it
    base = z((1, 2, 8, 65), dtype=bf, device=dev)
    ok = z((1, 2, 8, 64), dtype=bf, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention(base[..., 1:], ok, ok)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention(base[..., :64], ok, ok)


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_batched_dual_lora_matches_plain(dev, dtype):
    """Per-row Eq. 7 over a personalized bank and a global pair, fusion
    weights in [-0.2, 1.2]; one row with an id outside the bank gets the
    global term only, as the TPU kernel's zero one-hot row does."""
    gen = torch.Generator(device=dev).manual_seed(5)
    M, K, N, C, r = 70, 256, 200, 4, 16
    x = _randn(gen, (M, K), dev, dtype)
    w = _randn(gen, (K, N), dev, dtype, 0.05)
    a1 = _randn(gen, (C, K, r), dev, std=0.05)
    b1 = _randn(gen, (C, r, N), dev, std=0.05)
    a2 = _randn(gen, (K, r), dev, std=0.05)
    b2 = _randn(gen, (r, N), dev, std=0.05)
    ids = torch.randint(0, C, (M,), generator=gen, device=dev,
                        dtype=torch.int32)
    fw = (torch.rand((M, 2), generator=gen, device=dev) * 1.4 - 0.2)
    kernels.reset_launch_counts()
    y = batched_dual_lora_matmul(x, w, a1, b1, a2, b2, ids, fw, 2.0)
    yr = ref.batched_dual_lora_matmul_ref(x, w, a1, b1, a2, b2, ids, fw, 2.0)
    if dtype == torch.bfloat16:
        assert float((y.float() - yr.float()).abs().max()) <= _bf16_tol(yr)
    else:
        torch.testing.assert_close(y, yr, atol=1e-4, rtol=1e-4)
    assert kernels.launch_counts()["batched_dual_lora_matmul"] == 1
    ids_out = ids.clone()
    ids_out[3] = C
    y_out = batched_dual_lora_matmul(x, w, a1, b1, a2, b2, ids_out, fw, 2.0)
    fw_g = fw[3:4] * torch.tensor([0.0, 1.0], device=dev)
    y_g = ref.batched_dual_lora_matmul_ref(x[3:4], w, a1, b1, a2, b2,
                                           ids[3:4], fw_g, 2.0)
    assert float((y_out[3:4].float() - y_g.float()).abs().max()) <= \
        _bf16_tol(y_g) + 1e-4
    with pytest.raises(RuntimeError, match="forward only"):
        batched_dual_lora_matmul(x, w, a1.requires_grad_(True), b1, a2, b2,
                                 ids, fw, 2.0)


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


# ---------------------------------------------------------------------------
# the LoRA tiles: tensor-core (bf16 x and W) and fp32, by plan
# ---------------------------------------------------------------------------

# (M, K, N) and the plan they are meant to take: (tile kind, K split above
# 1).  K and N are multiples of 8 but not of the 32-deep K stage or of the
# tiles' columns; together they run every tile with and without split-K.
LORA_SHAPES = [
    ((1, 8, 8), (0, False)),
    ((8, 104, 200), (0, False)),
    ((8, 1032, 200), (0, True)),
    ((40, 96, 136), (1, False)),
    ((40, 520, 136), (1, True)),
    ((70, 520, 200), (2, False)),
    ((300, 4104, 264), (2, False)),
    ((2048, 264, 1032), (2, False)),
]


def _lora_case(gen, dev, M, K, N, C, r, variant):
    """bf16 x and W; a bank of C clients; ids in runs of 1-40 rows (rows of
    a request share a client, so some tiles mix clients), a few outside
    [0, C)."""
    rng = np.random.default_rng(M * 7 + K)
    x = _randn(gen, (M, K), dev, torch.bfloat16)
    w = _randn(gen, (K, N), dev, torch.bfloat16, K ** -0.5)
    a = _randn(gen, (C, K, r), dev, std=1.0 / r)
    b = _randn(gen, (C, r, N), dev, std=0.05)
    runs = rng.integers(1, 41, M)
    ids = np.repeat(rng.integers(-1, C + 1, M), runs)[:M].astype(np.int32)
    kw = {}
    if variant == "rank_mask":
        kw["ranks"] = torch.as_tensor(rng.integers(1, r + 1, C),
                                      dtype=torch.int32, device=dev)
    if variant == "int8_bank":
        a, sa = quantize_int8(a, (1, 2))
        b, sb = quantize_int8(b, (1, 2))
        kw.update(a_scale=sa, b_scale=sb)
    return x, w, a, b, torch.as_tensor(ids, device=dev), kw


def _lora_plain(x, w, a, b, ids, **kw):
    """The plain version with the kernels' rule for ids outside [0, C) (no
    LoRA term, as the TPU kernel's zero one-hot row gives): such rows get
    x·W alone; the plain version itself only ever sees ids in range."""
    C = a.shape[0]
    dead = (ids < 0) | (ids >= C)
    yr = ref.batched_lora_matmul_ref(x, w, a, b,
                                     torch.where(dead, 0, ids), 2.0, **kw)
    base = (x.float() @ w.float()).to(x.dtype)
    return torch.where(dead[:, None], base, yr)


@pytest.mark.parametrize("variant", ["f32_bank", "rank_mask", "int8_bank"])
@pytest.mark.parametrize("shape,want", LORA_SHAPES)
def test_batched_lora_tiles_match_plain(dev, shape, want, variant):
    """The tensor-core tile against the plain version (two bf16 roundings
    of the largest output: both compute in fp32 and round once) and
    against the plan's own arithmetic (``lora_tile.split_plan_ref``) at
    edge shapes, mixed-client tiles and dead ids; the fp32 tile on the
    same inputs at 1e-4; each launch counted on the tile it ran."""
    from repro_torch.kernels import lora_tile
    M, K, N = shape
    p = lora_tile.plan(M, N, K)
    assert (p.kind, p.split > 1) == want
    gen = torch.Generator(device=dev).manual_seed(11)
    x, w, a, b, ids, kw = _lora_case(gen, dev, M, K, N, 5, 16, variant)
    kernels.reset_launch_counts()
    y = batched_lora_matmul(x, w, a, b, ids, 2.0, **kw)
    assert kernels.tile_counts()["batched_lora_matmul"] == {"mma": 1,
                                                             "f32": 0}
    yr = _lora_plain(x, w, a, b, ids, **kw)
    assert bool(torch.isfinite(y.float()).all())
    assert float((y.float() - yr.float()).abs().max()) <= _bf16_tol(yr)
    yp, _ = lora_tile.split_plan_ref(x, w, a, b, ids, 2.0, **kw)
    assert float((y.float() - yp.float()).abs().max()) <= _bf16_tol(yp)
    y32 = batched_lora_matmul(x.float(), w.float(), a, b, ids, 2.0, **kw)
    torch.testing.assert_close(
        y32, _lora_plain(x.float(), w.float(), a, b, ids, **kw),
        atol=1e-4, rtol=1e-4)
    assert kernels.tile_counts()["batched_lora_matmul"] == {"mma": 1,
                                                             "f32": 1}
    assert kernels.launch_counts()["batched_lora_matmul"] == 2


# whisper-small's projections (K 768 / N 3072, K 3072 / N 768) at its
# train step's 2,048 decoder rows and its decode step's 8
WHISPER_LORA_SHAPES = [((2048, 768, 3072), (2, False)),
                       ((2048, 3072, 768), (2, False)),
                       ((8, 768, 3072), (0, True)),
                       ((8, 3072, 768), (0, True))]


@pytest.mark.parametrize("shape,want", LORA_SHAPES + WHISPER_LORA_SHAPES)
def test_lora_matmul_tiles_match_plain(dev, shape, want):
    """lora_matmul through both tiles at the same shapes: y to two bf16
    roundings (tensor-core tile) or 1e-4 (fp32 tile), and the z it keeps
    for the backward equal to fp32 x·A within fp32 summation order."""
    from repro_torch.kernels import lora_tile
    from repro_torch.kernels.lora_matmul import _launch, lora_matmul
    M, K, N = shape
    gen = torch.Generator(device=dev).manual_seed(12)
    x = _randn(gen, (M, K), dev, torch.bfloat16)
    w = _randn(gen, (K, N), dev, torch.bfloat16, K ** -0.5)
    a = _randn(gen, (K, 16), dev, std=1.0 / 16)
    b = _randn(gen, (16, N), dev, std=0.05)
    kernels.reset_launch_counts()
    y, z = _launch(x, w, a, b, 2.0)
    yr = ref.lora_matmul_ref(x, w, a, b, 2.0)
    assert float((y.float() - yr.float()).abs().max()) <= _bf16_tol(yr)
    torch.testing.assert_close(z, x.float() @ a, atol=1e-4, rtol=1e-4)
    yp, _ = lora_tile.split_plan_ref(x, w, a[None], b[None], None, 2.0)
    assert float((y.float() - yp.float()).abs().max()) <= _bf16_tol(yp)
    y32 = lora_matmul(x.float(), w.float(), a, b, 2.0)
    torch.testing.assert_close(y32, ref.lora_matmul_ref(x.float(), w.float(),
                                                        a, b, 2.0),
                               atol=1e-4, rtol=1e-4)
    assert kernels.tile_counts()["lora_matmul"] == {"mma": 1, "f32": 1}


def test_lora_split_k_is_deterministic(dev):
    """The decode plan splits K and reduces the partials in a fixed order:
    the same call gives the same bits every time."""
    from repro_torch.kernels import lora_tile
    M, K, N = 8, 4096, 4096
    assert lora_tile.plan(M, N, K).split > 1
    gen = torch.Generator(device=dev).manual_seed(13)
    x, w, a, b, ids, _ = _lora_case(gen, dev, M, K, N, 8, 16, "f32_bank")
    y0 = batched_lora_matmul(x, w, a, b, ids, 2.0)
    for _ in range(5):
        assert torch.equal(batched_lora_matmul(x, w, a, b, ids, 2.0), y0)
    yr = _lora_plain(x, w, a, b, ids)
    assert float((y0.float() - yr.float()).abs().max()) <= _bf16_tol(yr)


def _dual_plain(x, w, a1, b1, a2, b2, ids, fw):
    """The plain per-row dual version with the kernels' rule for ids
    outside [0, C): no personalized term (w1 taken as 0), as the TPU
    kernel's zero one-hot row gives."""
    C = a1.shape[0]
    dead = (ids < 0) | (ids >= C)
    fw = torch.where(dead[:, None] & (torch.arange(2, device=ids.device)
                                      == 0)[None], torch.zeros_like(fw), fw)
    return ref.batched_dual_lora_matmul_ref(
        x, w, a1, b1, a2, b2, torch.where(dead, 0, ids), fw, 2.0)


@pytest.mark.parametrize("r", [1, 64, 128])
@pytest.mark.parametrize("shape,want", LORA_SHAPES)
def test_dual_lora_tiles_match_plain(dev, shape, want, r):
    """Both dual kernels through both tiles at the LoRA edge shapes (every
    plan: split-K decode tiles, the 64 x 128 tile, the wgmma tile; ragged
    M, N and K), ranks 1, 64 and 128 (the batched kernel's concatenated
    operand up to 256), ids in runs with some outside [0, C), fusion
    weights in [-0.2, 1.2] and a negative scalar weight.  bf16 outputs
    (the tensor-core tile): within two bf16 roundings of the largest
    output of the plain version, and every row within two bf16 ulps of its
    largest output of the tile model (``lora_tile.dual_split_plan_ref``),
    which a dropped or doubled stage of either pair breaks; fp32
    activations (the CUDA-core tile) at 1e-4.  Each launch is counted on
    the tile it ran."""
    from repro_torch.kernels import attn_tile, lora_tile
    from repro_torch.kernels.dual_lora import dual_lora_matmul
    M, K, N = shape
    p = lora_tile.plan(M, N, K)
    assert (p.kind, p.split > 1) == want
    gen = torch.Generator(device=dev).manual_seed(14)
    C = 5
    x, w, a1, b1, ids, _ = _lora_case(gen, dev, M, K, N, C, r, "f32_bank")
    a2 = _randn(gen, (K, r), dev, std=1.0 / r)
    b2 = _randn(gen, (r, N), dev, std=0.05)
    fw = torch.rand((M, 2), generator=gen, device=dev) * 1.4 - 0.2
    fs = torch.tensor([1.1, -0.2], device=dev)
    kernels.reset_launch_counts()
    y = batched_dual_lora_matmul(x, w, a1, b1, a2, b2, ids, fw, 2.0)
    ys = dual_lora_matmul(x, w, a1[1], b1[1], a2, b2, fs, 2.0)
    tiles = kernels.tile_counts()
    assert tiles["batched_dual_lora_matmul"] == {"mma": 1, "f32": 0}
    assert tiles["dual_lora_matmul"] == {"mma": 1, "f32": 0}
    for out, plain, model in (
            (y, _dual_plain(x, w, a1, b1, a2, b2, ids, fw),
             lora_tile.dual_split_plan_ref(x, w, a1, b1, a2, b2, ids, fw,
                                           2.0)),
            (ys, ref.dual_lora_matmul_ref(x, w, a1[1], b1[1], a2, b2, fs[0],
                                          fs[1], 2.0),
             lora_tile.dual_split_plan_ref(x, w, a1[1], b1[1], a2, b2, None,
                                           fs, 2.0))):
        assert bool(torch.isfinite(out.float()).all())
        assert float((out.float() - plain.float()).abs().max()) <= \
            _bf16_tol(plain)
        assert attn_tile.tile_errors(out, model)[1] <= 1.0
    xf, wf = x.float(), w.float()
    torch.testing.assert_close(
        batched_dual_lora_matmul(xf, wf, a1, b1, a2, b2, ids, fw, 2.0),
        _dual_plain(xf, wf, a1, b1, a2, b2, ids, fw), atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(
        dual_lora_matmul(xf, wf, a1[1], b1[1], a2, b2, fs, 2.0),
        ref.dual_lora_matmul_ref(xf, wf, a1[1], b1[1], a2, b2, fs[0], fs[1],
                                 2.0), atol=1e-4, rtol=1e-4)
    tiles = kernels.tile_counts()
    assert tiles["batched_dual_lora_matmul"] == {"mma": 1, "f32": 1}
    assert tiles["dual_lora_matmul"] == {"mma": 1, "f32": 1}
    counts = kernels.launch_counts()
    assert counts["batched_dual_lora_matmul"] == counts["dual_lora_matmul"] \
        == 2


def test_four_lora_libraries_load_together(dev):
    """The four LoRA sources each instantiate ``lora_mma.cuh``'s tile in
    their own library; loaded into one process, each still launches its
    tensor-core tile with its own shared-memory attribute (the header's
    internal linkage), in either order of first use."""
    from repro_torch.kernels import build
    from repro_torch.kernels.dual_lora import dual_lora_matmul
    from repro_torch.kernels.lora_matmul import lora_matmul
    gen = torch.Generator(device=dev).manual_seed(15)
    M, K, N, C, r = 300, 520, 264, 3, 16     # the wgmma tile (largest smem)
    x, w, a, b, ids, _ = _lora_case(gen, dev, M, K, N, C, r, "f32_bank")
    fw = torch.rand((M, 2), generator=gen, device=dev)
    fs = fw[0].contiguous()
    calls = {
        "batched_lora_matmul": (
            lambda: batched_lora_matmul(x, w, a, b, ids, 2.0),
            lambda: _lora_plain(x, w, a, b, ids)),
        "lora_matmul": (lambda: lora_matmul(x, w, a[0], b[0], 2.0),
                        lambda: ref.lora_matmul_ref(x, w, a[0], b[0], 2.0)),
        "dual_lora_matmul": (
            lambda: dual_lora_matmul(x, w, a[0], b[0], a[1], b[1], fs, 2.0),
            lambda: ref.dual_lora_matmul_ref(x, w, a[0], b[0], a[1], b[1],
                                             fs[0], fs[1], 2.0)),
        "batched_dual_lora_matmul": (
            lambda: batched_dual_lora_matmul(x, w, a, b, a[2], b[2], ids, fw,
                                             2.0),
            lambda: _dual_plain(x, w, a, b, a[2], b[2], ids, fw)),
    }
    for order in (list(calls), list(reversed(calls))):
        kernels.reset_launch_counts()
        for name in order:
            run, plain = calls[name]
            out, want = run(), plain()
            torch.cuda.synchronize()
            assert float((out.float() - want.float()).abs().max()) <= \
                _bf16_tol(want), name
        assert all(kernels.tile_counts()[n] == {"mma": 1, "f32": 0}
                   for n in calls)
    assert {"batched_lora", "lora_matmul", "dual_lora",
            "batched_dual_lora"} <= set(build._LIBS)


def test_lora_tiles_refuse_misaligned_bf16(dev):
    from repro_torch.kernels.lora_matmul import lora_matmul
    bf = torch.bfloat16
    a = torch.zeros((2, 20, 4), device=dev)
    b = torch.zeros((2, 4, 16), device=dev)
    ids = torch.zeros((3,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="multiples of 8"):     # K = 20
        batched_lora_matmul(torch.zeros((3, 20), dtype=bf, device=dev),
                            torch.zeros((20, 16), dtype=bf, device=dev),
                            a, b, ids)
    flat = torch.zeros(3 * 16 + 1, dtype=bf, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        lora_matmul(flat[1:].view(3, 16), torch.zeros((16, 8), dtype=bf,
                                                      device=dev),
                    torch.zeros((16, 4), device=dev),
                    torch.zeros((4, 8), device=dev))
    # the fp32 tile takes any width
    y = batched_lora_matmul(torch.zeros((3, 20), device=dev),
                            torch.zeros((20, 16), device=dev), a, b, ids)
    assert y.shape == (3, 16)


def test_dual_tiles_refuse_misaligned_bf16(dev):
    """The dual kernels take the tensor-core tile by the same rule, so
    they refuse what it does not take; the fp32 tile takes any width."""
    from repro_torch.kernels.dual_lora import dual_lora_matmul
    bf = torch.bfloat16
    a, b = torch.zeros((20, 4), device=dev), torch.zeros((4, 16), device=dev)
    ids = torch.zeros((3,), dtype=torch.int32, device=dev)
    fw = torch.ones((3, 2), device=dev)
    x = torch.zeros((3, 20), dtype=bf, device=dev)
    w = torch.zeros((20, 16), dtype=bf, device=dev)
    with pytest.raises(ValueError, match="multiples of 8"):     # K = 20
        dual_lora_matmul(x, w, a, b, a, b, fw[0], 2.0)
    with pytest.raises(ValueError, match="multiples of 8"):
        batched_dual_lora_matmul(x, w, a[None], b[None], a, b, ids, fw, 2.0)
    y = batched_dual_lora_matmul(x.float(), w.float(), a[None], b[None], a,
                                 b, ids, fw, 2.0)
    assert y.shape == (3, 16)


@pytest.mark.parametrize("arch", ["llama2-7b", "gemma-2b", "olmo-1b",
                                  "yi-6b", "starcoder2-15b"])
def test_smoke_engine_serves_through_the_kernels(dev, arch):
    """A few requests on each dense arch's smoke config through the "cuda"
    backend (starcoder2-smoke's prompts run past its window of 16): every
    kernel launches, and each request's first greedy token matches the
    "torch" backend's (fp32 activations, two layers: the paths differ by
    summation order only)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_engine, ragged_requests
    from repro_torch.serving.engine import ServeConfig
    cfg = get_config(arch, smoke=True).with_overrides(dtype="float32")
    eng = build_engine(cfg, 3, dev, seed=0, rank=8)
    reqs = ragged_requests(4, 3, cfg.vocab_size, 10, 40, seed=0)
    sc = ServeConfig(batch_size=3, max_new_tokens=5, prefill_chunk=16,
                     block_size=4, num_blocks=20)
    kernels.reset_launch_counts()
    out = eng.generate(reqs, sc)
    counts = kernels.launch_counts()
    assert all(counts[name] > 0 for name in kernels.SERVING)
    assert [len(o) for o in out] == [5] * 4
    ref_out = eng.generate(reqs, dataclasses.replace(sc,
                                                     paged_backend="torch"))
    assert [o[0] for o in out] == [o[0] for o in ref_out]


def _next_logits(eng, req, tokens, sc, backend):
    """(V,) fp32 logits after feeding ``req.prompt + tokens`` through a
    fresh pool in prefill chunks on ``backend``: what the stream's next
    greedy decision saw."""
    from repro_torch.serving.kv_cache import PagedKVCache, blocks_needed
    seq = np.concatenate([np.asarray(req.prompt, np.int32),
                          np.asarray(tokens, np.int32)])
    per = blocks_needed(len(seq), sc.block_size)
    kv = PagedKVCache(1, sc.block_size, 1 + per, per)
    kv.admit(0)
    assert kv.ensure(0, len(seq))
    dev = eng.device
    cache = eng.model.init_paged_decode_cache(1 + per, sc.block_size,
                                              kv_dtype=sc.kv_dtype,
                                              num_slots=1)
    ids = torch.tensor([eng.registry.acquire(req.client_id)],
                       dtype=torch.int32, device=dev)
    bank = eng.bank_for(dataclasses.replace(sc, paged_backend=backend))
    pos, T = 0, sc.prefill_chunk
    while pos < len(seq):
        n = min(T, len(seq) - pos)
        chunk = torch.zeros((1, T), dtype=torch.int32)
        chunk[0, :n] = torch.from_numpy(seq[pos:pos + n])
        bt, _ = kv.device_tables(dev)
        logits, cache = eng.model.prefill_step(
            eng.params, cache, chunk.to(dev),
            torch.tensor([pos], dtype=torch.int32, device=dev),
            torch.tensor([n], dtype=torch.int32, device=dev), adapters=bank,
            lora_scale=eng.scale, adapter_ids=ids, block_tables=bt,
            paged_backend=backend)
        pos += n
    return logits[0, n - 1]


def assert_streams_agree_by_margin(eng, reqs, sc, got, want, err, backend):
    """Streams ``got`` equal ``want`` (``backend``'s) up to their first
    difference, and there the decision was within the error: its top-2
    margin on ``backend`` is at most twice ``err``."""
    for req, g, w in zip(reqs, got, want):
        t = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if t is not None:
            top2 = torch.topk(_next_logits(eng, req, w[:t], sc, backend),
                              2).values
            m = float(top2[0] - top2[1])
            assert m <= 2 * err, (req.client_id, t, m, err)


def test_smoke_engine_serves_options_through_the_kernels(dev):
    """int8 K/V, a ragged int8 bank, prefix caching (cold, then warm) and
    speculative decoding through the kernels: every serving kernel
    launches, and the streams agree with the "torch" backend's by the
    margin rule (fp32 activations, two layers: the paths differ in
    summation order, and an int8 K/V value may round to the other step)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_engine, ragged_requests
    from repro_torch.serving.engine import ServeConfig
    cfg = get_config("llama2-7b", smoke=True).with_overrides(dtype="float32")
    eng = build_engine(cfg, 4, dev, seed=0, ranks=[4, 8, 16],
                       bank_dtype="int8")
    reqs = ragged_requests(6, 4, cfg.vocab_size, 10, 40, seed=0)
    for r in reqs:                      # repetition: drafts get accepted
        r.prompt = np.concatenate([r.prompt, r.prompt[:12]])
    sc = ServeConfig(batch_size=3, max_new_tokens=8, prefill_chunk=16,
                     block_size=4, num_blocks=40, kv_dtype="int8",
                     prefix_cache=True, spec_decode=True, spec_k=3)
    kernels.reset_launch_counts()
    cold = eng.generate(reqs, sc)
    warm = eng.generate(reqs, sc)
    st = eng.last_stats
    counts = kernels.launch_counts()
    assert all(counts[name] > 0 for name in kernels.SERVING)
    assert st["prefix_pool_reused"] and st["prefix_hit_tokens"] > 0
    assert st["verify_dispatches"] > 0
    eng.release_prefix_cache()
    tsc = dataclasses.replace(sc, paged_backend="torch")
    want = eng.generate(reqs, tsc)
    assert kernels.launch_counts() == counts       # "torch" launches none
    # the error the margins are held against: the largest difference of the
    # prompts' last logits, cuda vs torch
    err = max(float((_next_logits(eng, r, [], sc, "cuda")
                     - _next_logits(eng, r, [], sc, "torch")).abs().max())
              for r in reqs)
    for got in (cold, warm):
        assert_streams_agree_by_margin(eng, reqs, tsc, got, want, err,
                                       "torch")


def test_serve_cli_with_options_on_the_card(dev, capsys):
    from repro_torch.launch.serve import main
    kernels.reset_launch_counts()
    main(["--smoke", "--kv-dtype", "int8", "--ranks", "4,8", "--bank-dtype",
          "int8", "--prefix-cache", "--spec-decode", "--tenants", "3",
          "--batch", "2"])
    out = capsys.readouterr().out
    assert "kv=int8, bank=int8" in out and "pool reused True" in out
    assert all(kernels.launch_counts()[n] > 0 for n in kernels.SERVING)


# ---------------------------------------------------------------------------
# overlapped dispatch on the card
# ---------------------------------------------------------------------------

def _overlap_engine(dev, tenants=3):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_engine
    return build_engine(get_config("llama2-7b", smoke=True), tenants, dev,
                        seed=0, rank=8)


def _overlap_trace(eng, n=10, seed=0):
    from repro_torch.serving.trace import synth_trace
    return synth_trace(seed, n, arrival="bursty", rate=40.0,
                       prompt_mean=24.0, prompt_max=64, out_mean=12.0,
                       out_max=24, clients=("client0", "client1", "client2"),
                       vocab_size=eng.cfg.vocab_size)


def _overlap_sc(**kw):
    # 16-token blocks and 4-step decode chunks: a slot often has the slack
    # for its next chunk, so a deferred chunk stays unread through a round
    from repro_torch.serving.engine import ServeConfig
    base = dict(batch_size=4, max_new_tokens=24, block_size=16,
                num_blocks=1 + 4 * 6, max_blocks_per_slot=6, prefill_chunk=16,
                scan_chunk=4)
    base.update(kw)
    return ServeConfig(**base)


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_overlap_streams_equal_the_synchronous_loop_on_the_card(
        dev, temperature):
    """Logical mode, bf16, every serving kernel: the same dispatches with
    overlap on and off give bitwise equal streams, greedy and sampled."""
    from repro_torch.serving.trace import run_trace
    eng = _overlap_engine(dev)
    tr = _overlap_trace(eng)
    kernels.reset_launch_counts()
    on = run_trace(eng, _overlap_sc(temperature=temperature, seed=5), tr)
    counts = kernels.launch_counts()
    off = run_trace(eng, _overlap_sc(temperature=temperature, seed=5,
                                     overlap=False), tr)
    assert on["completed"] == off["completed"] == len(tr)
    assert on["streams"] == off["streams"]
    assert on["last_stats"]["deferred_chunks"] > 0
    assert off["last_stats"]["deferred_chunks"] == 0
    assert all(counts[name] > 0 for name in kernels.SERVING)


def _rounds_without_sync(ses):
    """Step ``ses`` to its end with CUDA's sync debug mode set to raise on
    any call that waits for the stream (a blocking copy, ``.item()``,
    ``.cpu()``, a stream synchronize); the readbacks wait on their own
    events, which that mode does not flag.  Returns the rounds as (prefill
    dispatched, events, pipelined) triples: a pipelined round found a
    deferred chunk it kept unread through planning and deferred its own."""
    rounds = []
    sched = ses.sched
    torch.cuda.set_sync_debug_mode("error")
    try:
        while ses.has_work:
            pre = (sched.prefill_dispatches, ses.deferred_chunks)
            kept = ses._pending is not None and not (
                sched.queued or sched.prefill_pending
                or ses._growth_possible())
            events = ses.step()
            rounds.append((sched.prefill_dispatches > pre[0], events,
                           kept and ses.deferred_chunks > pre[1]))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ses.finalize()
    return rounds


def test_pipelined_rounds_do_not_wait_for_the_card(dev):
    """The rounds overlap pipelines (a prompt-only prefill round, a decode
    round whose predecessor was deferred) and every other round of the
    session run without a call that waits for the stream, sampling at
    temperature > 0 included."""
    from repro_torch.serving.engine import Request
    eng = _overlap_engine(dev)
    eng.generate([Request("client0", np.arange(1, 20, dtype=np.int32))],
                 _overlap_sc())                 # builds and warms up
    ses = eng.session(_overlap_sc(temperature=0.7))
    for i in range(3):                          # prompts of 3-4 chunks
        ses.submit(Request(f"client{i}",
                           (np.arange(40 + 9 * i) * (i + 3)) % 500 + 1,
                           max_new_tokens=20))
    rounds = _rounds_without_sync(ses)
    assert any(pre and not events for pre, events, _ in rounds), \
        "no prompt-only prefill round"
    assert any(pipelined for _, _, pipelined in rounds), \
        "no deferred decode round after a deferred one"


@pytest.mark.parametrize("overlap", [True, False])
def test_step_makes_no_blocking_copy(dev, overlap):
    """No round of ``step`` copies to or from the card in a way that waits
    for the stream, with int8 K/V, prefix caching and speculative decoding
    on (verify rounds, admissions with prefix hits): a ``torch.tensor(...,
    device=...)`` from host memory or a ``.cpu()`` put back into the step
    fails this test."""
    from repro_torch.serving.engine import Request
    eng = _overlap_engine(dev)
    sc = _overlap_sc(kv_dtype="int8", prefix_cache=True, spec_decode=True,
                     spec_k=3, overlap=overlap)
    motif = np.arange(7, 19, dtype=np.int32)
    reqs = [Request(f"client{i % 3}", np.concatenate(
        [np.tile(motif, 3), np.arange(i + 1, 2 * i + 9, dtype=np.int32)]),
        max_new_tokens=12) for i in range(5)]
    eng.generate(reqs[:1], sc)                  # builds and warms up
    ses = eng.session(sc)
    for r in reqs:
        ses.submit(r)
    rounds = _rounds_without_sync(ses)
    st = eng.last_stats
    assert st["verify_dispatches"] > 0 and st["prefix_hit_tokens"] > 0
    assert sum(len(t) for _, ev, _ in rounds for _, t, _ in ev) == 5 * 12


# ---------------------------------------------------------------------------
# sharded serving, the fixed path and the single-tenant engine on the card
# ---------------------------------------------------------------------------

def _sharded_engine(dev, variant):
    """The llama2 smoke config in bf16, 4 tenants in a 2-shard registry:
    the fp32 bank, or rank buckets 4 and 8 in an int8 bank."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_engine
    kw = ({} if variant == "fp32" else
          dict(ranks=[4, 8], bank_dtype="int8"))
    return build_engine(get_config("llama2-7b", smoke=True), 4, dev, seed=0,
                        rank=8, shards=2, **kw)


@pytest.mark.parametrize("variant", ["fp32", "int8"])
def test_sharded_streams_equal_the_single_pool_on_the_card(dev, variant):
    """Through every serving kernel in bf16: 2 shards give the streams of
    one pool, bitwise (the rows are only permuted across the batch, and no
    kernel's row output depends on its place in the batch); int8 K/V over a
    ragged int8 bank against the int8 single pool."""
    from repro_torch.launch.serve import ragged_requests
    from repro_torch.serving.engine import ServeConfig
    eng = _sharded_engine(dev, variant)
    reqs = ragged_requests(8, 4, eng.cfg.vocab_size, 10, 60, seed=0)
    kv = "f32" if variant == "fp32" else "int8"
    sc = ServeConfig(batch_size=4, max_new_tokens=10, prefill_chunk=16,
                     block_size=8, num_blocks=41, kv_dtype=kv)
    one = eng.generate(reqs, sc)
    kernels.reset_launch_counts()
    two = eng.generate(reqs, dataclasses.replace(sc, num_shards=2))
    st = eng.last_stats
    assert all(kernels.launch_counts()[n] > 0 for n in kernels.SERVING)
    assert st["num_shards"] == 2 and st["shard_placements"]["adapter"] == 8
    for a, b in zip(one, two):
        np.testing.assert_array_equal(a, b)


def test_sharded_rounds_do_not_wait_for_the_card(dev):
    """The sharded round loop (2 shards, overlap on, a ragged int8 bank
    whose kernel view is rebuilt after a mid-stream registration) makes no
    call that waits for the stream."""
    from repro_torch.launch.serve import ragged_requests, register_client
    from repro_torch.serving.engine import ServeConfig
    eng = _sharded_engine(dev, "int8")
    reqs = ragged_requests(6, 4, eng.cfg.vocab_size, 10, 60, seed=1)
    sc = ServeConfig(batch_size=4, max_new_tokens=12, prefill_chunk=16,
                     block_size=8, num_blocks=41, num_shards=2)
    eng.generate(reqs[:2], sc)                  # builds and warms up
    ses = eng.session(sc, reqs)
    rounds = 0
    while ses.has_work:
        torch.cuda.set_sync_debug_mode("error")
        try:
            ses.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        rounds += 1
        if rounds == 2:                          # a hot-swap lands
            register_client(eng.registry, eng.cfg, 1, dev, 500, [4, 8])
    st = ses.finalize()
    assert st["adapter_bank_refreshes"] == 1 and st["num_shards"] == 2


@pytest.mark.parametrize("M", [1, 2, 8, 16, 33, 64])
@pytest.mark.parametrize("K,N", [(4096, 4096), (4096, 11008), (11008, 4096)])
def test_lora_matmul_at_decode_rows_matches_plain(dev, M, K, N):
    """``lora_matmul`` at the single-tenant engine's decode rows (one row
    per batch row) on llama2-7b's projections: the tensor-core tile's
    split-K plan within two bf16 roundings of the plain version, and of
    the plan's own arithmetic."""
    from repro_torch.kernels import lora_tile
    from repro_torch.kernels.lora_matmul import lora_matmul
    gen = torch.Generator(device=dev).manual_seed(M + K)
    x = _randn(gen, (M, K), dev, torch.bfloat16)
    w = _randn(gen, (K, N), dev, torch.bfloat16, K ** -0.5)
    a = _randn(gen, (K, 16), dev, std=1.0 / 16)
    b = _randn(gen, (16, N), dev, std=0.02)
    kernels.reset_launch_counts()
    y = lora_matmul(x, w, a, b, 2.0)
    assert kernels.tile_counts()["lora_matmul"] == {"mma": 1, "f32": 0}
    yr = ref.lora_matmul_ref(x, w, a, b, 2.0)
    assert bool(torch.isfinite(y.float()).all())
    assert float((y.float() - yr.float()).abs().max()) <= _bf16_tol(yr)
    yp, _ = lora_tile.split_plan_ref(x, w, a[None], b[None], None, 2.0)
    assert float((y.float() - yp.float()).abs().max()) <= _bf16_tol(yp)


def test_fixed_path_and_engine_serve_through_the_kernels(dev):
    """``generate_fixed`` runs the batched LoRA kernel and ``Engine`` with
    one adapter the single-pair kernel, both on the tensor-core tile (bf16);
    the last prompt position's logits agree with the "torch" backend's
    within the first-chunk bound (10% of the largest logit), the greedy
    token wherever the margin exceeds twice the error."""
    from repro_torch.core.dual_lora import merge
    from repro_torch.core.lora import init_adapters
    from repro_torch.serving.engine import Engine, Request, ServeConfig
    eng = _sharded_engine(dev, "fp32")
    cfg = eng.cfg
    prompt = (np.arange(24, dtype=np.int32) * 7 + 3) % cfg.vocab_size
    reqs = [Request(f"client{i % 4}", prompt) for i in range(4)]
    sc = ServeConfig(batch_size=4, max_new_tokens=8, cache_len=64)
    kernels.reset_launch_counts()
    fixed = eng.generate_fixed(reqs, sc)
    assert kernels.tile_counts()["batched_lora_matmul"]["mma"] > 0
    assert fixed.shape == (4, 8) and fixed.device.type == "cuda"
    pair = [init_adapters(cfg, seed=s, device=dev, b_std=0.02)
            for s in (1, 2)]
    single = Engine(eng.model, cfg, eng.params, merge(*pair, [0.6, 0.6]))
    kernels.reset_launch_counts()
    out = single.generate(np.tile(prompt, (4, 1)), sc)
    assert kernels.tile_counts()["lora_matmul"] == {
        "mma": kernels.launch_counts()["lora_matmul"], "f32": 0}
    assert kernels.launch_counts()["lora_matmul"] > 0
    assert bool((out >= 0).all()) and bool((out < cfg.vocab_size).all())
    prompts = torch.as_tensor(np.tile(prompt, (4, 1)), device=dev)
    ids = torch.tensor([eng.registry.acquire(r.client_id) for r in reqs],
                       dtype=torch.int32, device=dev)
    for e, routed in ((eng, True), (single, False)):
        logits = {}
        for backend in ("cuda", "torch"):
            bank = (e.bank_for(dataclasses.replace(sc, paged_backend=backend))
                    if routed else e.adapters)
            _, _, logits[backend] = e._prefill(
                e.params, bank, ids if routed else None,
                e.model.init_decode_cache(4, sc.cache_len), prompts, backend)
        err = float((logits["cuda"] - logits["torch"]).abs().max())
        assert err <= 0.1 * float(logits["torch"].abs().max())
        top2 = torch.topk(logits["torch"], 2, dim=-1).values
        decisive = (top2[:, 0] - top2[:, 1]) > 2 * err
        agree = logits["cuda"].argmax(-1) == logits["torch"].argmax(-1)
        assert bool(agree[decisive].all())


# ---------------------------------------------------------------------------
# the training path's kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_lora_and_dual_lora_match_plain(dev, dtype):
    from repro_torch.kernels.dual_lora import dual_lora_matmul
    from repro_torch.kernels.lora_matmul import lora_matmul
    gen = torch.Generator(device=dev).manual_seed(2)
    M, K, N, r = 70, 256, 200, 16
    x = _randn(gen, (M, K), dev, dtype)
    w = _randn(gen, (K, N), dev, dtype, 0.05)
    a1, a2 = (_randn(gen, (K, r), dev, std=0.05) for _ in range(2))
    b1, b2 = (_randn(gen, (r, N), dev, std=0.05) for _ in range(2))
    fw = torch.tensor([0.6, 0.7], device=dev)
    kernels.reset_launch_counts()
    y = lora_matmul(x, w, a1, b1, 2.0)
    yr = ref.lora_matmul_ref(x, w, a1, b1, 2.0)
    yd = dual_lora_matmul(x, w, a1, b1, a2, b2, fw, 2.0)
    ydr = ref.dual_lora_matmul_ref(x, w, a1, b1, a2, b2, fw[0], fw[1], 2.0)
    if dtype == torch.bfloat16:
        assert float((y.float() - yr.float()).abs().max()) <= _bf16_tol(yr)
        assert float((yd.float() - ydr.float()).abs().max()) <= _bf16_tol(ydr)
    else:         # the same function in fp32, summation order only
        torch.testing.assert_close(y, yr, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(yd, ydr, atol=1e-4, rtol=1e-4)
    counts = kernels.launch_counts()
    assert counts["lora_matmul"] == 1 and counts["dual_lora_matmul"] == 1
    with pytest.raises(RuntimeError, match="forward only"):
        dual_lora_matmul(x, w, a1.requires_grad_(True), b1, a2, b2, fw, 2.0)


@pytest.mark.parametrize("H,Kv,Sq,Sk,window", [
    (4, 4, 100, 100, 0), (4, 4, 96, 96, 17), (4, 4, 40, 130, 0),
    (8, 2, 64, 64, 0)])
def test_flash_attention_matches_plain(dev, H, Kv, Sq, Sk, window):
    from repro_torch.kernels.flash_attention import flash_attention
    gen = torch.Generator(device=dev).manual_seed(3)
    B, d = 2, 64
    q = _randn(gen, (B, H, Sq, d), dev, torch.bfloat16)
    k = _randn(gen, (B, Kv, Sk, d), dev, torch.bfloat16)
    v = _randn(gen, (B, Kv, Sk, d), dev, torch.bfloat16)
    o = flash_attention(q, k, v, sliding_window=window)
    orf = ref.flash_attention_ref(q, k, v, sliding_window=window)
    # the tile and the plain version round the probabilities to bf16 at
    # other points before the value product: that adds up to one bf16
    # rounding of the largest |v| to the two output roundings
    tol = _attn_tol(orf, v)
    assert float((o.float() - orf.float()).abs().max()) <= tol
    o32 = flash_attention(q.float(), k.float(), v.float(),
                          sliding_window=window)
    orf32 = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                    sliding_window=window)
    torch.testing.assert_close(o32, orf32, atol=2e-5, rtol=1e-5)


def test_autograd_backwards_match_plain_autograd(dev):
    """Gradients through the kernels' autograd functions equal those of
    plain autograd through the plain versions (fp32: the forwards differ
    by summation order only, and the backwards are plain PyTorch)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.lora_matmul import lora_matmul
    gen = torch.Generator(device=dev).manual_seed(4)
    M, K, N, r = 48, 96, 80, 8
    w = _randn(gen, (K, N), dev, std=0.05)
    leaves = [_randn(gen, s, dev, std=sd) for s, sd in
              (((M, K), 1.0), ((K, r), 0.05), ((r, N), 0.05))]
    dy = _randn(gen, (M, N), dev)
    grads = []
    for fn in (lora_matmul, ref.lora_matmul_ref):
        x, a, b = (t.clone().requires_grad_(True) for t in leaves)
        grads.append(torch.autograd.grad(fn(x, w, a, b, 2.0), (x, a, b), dy))
    for g, gr in zip(*grads):
        torch.testing.assert_close(g, gr, atol=1e-4, rtol=1e-4)
    qkv = [_randn(gen, (2, h, 64, 32), dev) for h in (4, 2, 2)]
    do = _randn(gen, (2, 4, 64, 32), dev)
    grads = []
    for fn in (flash_attention, ref.flash_attention_ref):
        q, k, v = (t.clone().requires_grad_(True) for t in qkv)
        grads.append(torch.autograd.grad(fn(q, k, v, sliding_window=20),
                                         (q, k, v), do))
    for g, gr in zip(*grads):
        torch.testing.assert_close(g, gr, atol=1e-4, rtol=1e-4)


def test_train_cli_smoke_runs_through_the_kernels(dev, tmp_path):
    """``launch/train.py --smoke`` on the card: every step runs the LoRA and
    flash-attention kernels and the loss stays finite."""
    import math

    from repro_torch.launch.train import main
    from repro_torch.training.checkpoint import load_checkpoint
    kernels.reset_launch_counts()
    ad = main(["--smoke", "--steps", "3", "--batch", "2", "--seq", "128",
               "--ckpt", str(tmp_path / "ad.npz")])
    counts = kernels.launch_counts()
    assert counts["lora_matmul"] > 0 and counts["flash_attention"] > 0
    back = load_checkpoint(str(tmp_path / "ad.npz"))
    leaf = back["layers"][0]["mlp"]["w_up"]["b"]
    assert leaf.device.type == "cuda"
    assert torch.equal(leaf, ad["layers"][0]["mlp"]["w_up"]["b"])
    assert all(math.isfinite(float(t.abs().sum()))
               for t in (leaf, ad["layers"][1]["mixer"]["wq"]["a"]))


# ---------------------------------------------------------------------------
# the federated baselines and the client-stacked round step on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r", [2, 8, 24, 32])
@pytest.mark.parametrize("shape", [(8, 1032, 200), (300, 4104, 264)])
def test_lora_matmul_at_the_baselines_ranks_matches_plain(dev, shape, r):
    """lora_matmul at FedKD's student rank (r/2) and FedRoD's concatenated
    rank (2r), partial and whole 16-wide rank groups of the tensor-core
    tile, through the split-K and the wgmma plans: y to two bf16 roundings,
    z = x·A and the fp32 tile's y to 1e-5 of their largest values (B is
    scaled up, so that a plain version without the LoRA term misses, and
    the outputs reach about 200 at r 2: the error scales with them)."""
    from repro_torch.kernels.lora_matmul import _launch, lora_matmul
    M, K, N = shape
    gen = torch.Generator(device=dev).manual_seed(13 + r)
    x = _randn(gen, (M, K), dev, torch.bfloat16)
    w = _randn(gen, (K, N), dev, torch.bfloat16, K ** -0.5)
    a = _randn(gen, (K, r), dev, std=1.0 / r)
    b = _randn(gen, (r, N), dev, std=0.5)
    kernels.reset_launch_counts()
    y, z = _launch(x, w, a, b, 2.0)
    yr = ref.lora_matmul_ref(x, w, a, b, 2.0)
    assert float((y.float() - yr.float()).abs().max()) <= _bf16_tol(yr)
    base = (x.float() @ w.float()).to(x.dtype)
    assert float((y.float() - base.float()).abs().max()) > 4 * _bf16_tol(yr)
    # A enters the shrink as a bf16 hi/lo pair (16 significant bits), and
    # at r 2 (A ~ 1/2) z reaches about 128: 1e-5 of its largest value
    zr = x.float() @ a
    torch.testing.assert_close(z, zr, rtol=1e-4,
                               atol=1e-5 * float(zr.abs().max()))
    y32 = lora_matmul(x.float(), w.float(), a, b, 2.0)
    yr32 = ref.lora_matmul_ref(x.float(), w.float(), a, b, 2.0)
    torch.testing.assert_close(y32, yr32, rtol=1e-4,
                               atol=1e-5 * float(yr32.abs().max()))
    assert kernels.tile_counts()["lora_matmul"] == {"mma": 1, "f32": 1}


def _smoke_fed(dtype="bfloat16"):
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SFTBatcher
    from repro_torch.data.synthetic import gen_log_dataset
    from repro_torch.data.tokenizer import ByteTokenizer
    cfg = get_config("llama2-7b", smoke=True).with_overrides(dtype=dtype)
    rng = np.random.default_rng(0)
    batchers = [SFTBatcher(gen_log_dataset(rng, 16, i), ByteTokenizer(), 128,
                           4, seed=i) for i in range(2)]
    return cfg, batchers


def test_baselines_fit_through_the_kernels(dev):
    """Every baseline's fit on the smoke model launches lora_matmul and
    flash_attention on their tensor-core tiles and no other kernel, returns
    finite adapters (FedRoD's at 2r) and counts its bytes."""
    from repro_torch.core.lora import tree_leaves
    from repro_torch.federated.baselines import BASELINES, FedConfig
    from repro_torch.models.api import Model
    cfg, batchers = _smoke_fed()
    model = Model(cfg, dev)
    params = model.init(0)
    fed = FedConfig(n_clients=2, rounds=2, local_steps=1)
    comm = {}
    for name, cls in BASELINES.items():
        method = cls(model, cfg, fed, params, device=dev)
        assert method.paged_backend == "cuda"
        kernels.reset_launch_counts()
        ads = method.fit(batchers)
        counts, tiles = kernels.launch_counts(), kernels.tile_counts()
        for k in ("lora_matmul", "flash_attention"):
            assert counts[k] > 0 and tiles[k] == {"mma": counts[k], "f32": 0}
        assert all(counts[k] == 0 for k in counts
                   if k not in ("lora_matmul", "flash_attention"))
        assert all(bool(torch.isfinite(t).all())
                   for ad in ads for _, t in tree_leaves(ad))
        want = 2 * cfg.lora_rank if name == "fedrod" else cfg.lora_rank
        assert ads[0]["layers"][0]["mlp"]["w_up"]["a"].shape[1] == want
        comm[name] = method.comm_bytes
    assert comm["local"] == 0 and 0 < comm["fedkd"] < comm["fedavg"]


@pytest.mark.parametrize("name", ["fedprox", "fedrod", "fedkd"])
def test_baseline_step_cuda_matches_torch(dev, name):
    """One step's loss and every adapter gradient of FedProx, FedRoD (its
    second forward at rank 2r) and FedKD (a rank-r/2 student) through the
    kernels against the plain path, fp32 activations: summation order
    only."""
    from repro_torch.core.lora import init_adapters, tree_leaves
    from repro_torch.federated.baselines import BASELINES, FedConfig
    from repro_torch.models.api import Model
    from repro_torch.training.train_step import value_and_grad
    cfg, batchers = _smoke_fed("float32")
    model = Model(cfg, dev)
    params = model.init(0)
    r = cfg.lora_rank
    ranks = (r, max(2, r // 2)) if name == "fedkd" else (r, r)
    first, second = (init_adapters(cfg, rank=rk, seed=5 + j, device=dev,
                                   b_std=0.05) for j, rk in enumerate(ranks))
    trees, extra = ((first, (second,)) if name == "fedprox"
                    else ((first, second), ()))
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in batchers[0].sample().items()}
    out = {}
    for backend in ("cuda", "torch"):
        kernels.reset_launch_counts()
        method = BASELINES[name](model, cfg, FedConfig(), params, device=dev,
                                 paged_backend=backend)
        loss, _, grads = value_and_grad(method.loss_fn())(trees, params,
                                                          batch, *extra)
        out[backend] = (float(loss), dict(tree_leaves(grads)),
                        kernels.launch_counts())
    (lc, gc, nc), (lt, gt, nt) = out["cuda"], out["torch"]
    assert nc["lora_matmul"] > 0 and all(n == 0 for n in nt.values())
    assert lc == pytest.approx(lt, rel=1e-5)
    for path in gt:
        scale = float(gt[path].abs().max())
        torch.testing.assert_close(gc[path], gt[path], rtol=1e-3,
                                   atol=1e-3 * scale, msg=path)


@pytest.mark.parametrize("compress", ["none", "bf16"])
def test_round_step_runs_through_the_kernels(dev, compress):
    """The client-stacked round step on the card equals the same clients
    run by hand through the train step (fp32 activations, fedavg outer
    step: the round ends at the client mean, up to the bf16 pseudo-
    gradient's rounding under compression)."""
    from repro_torch.core.lora import init_adapters, tree_leaves, tree_mean
    from repro_torch.core.outer_opt import make_outer_optimizer
    from repro_torch.federated.distributed import (make_fdlora_round_step,
                                                   stack_clients)
    from repro_torch.models.api import Model
    from repro_torch.training.optimizers import adamw
    from repro_torch.training.train_step import make_lora_train_step
    cfg, batchers = _smoke_fed("float32")
    model = Model(cfg, dev)
    params = model.init(0)
    inner, outer, K = adamw(lr=1e-3), make_outer_optimizer("fedavg"), 2
    theta = init_adapters(cfg, seed=3, device=dev, b_std=0.05)
    samples = [[b.sample() for _ in range(K)] for b in batchers]
    batches = {key: torch.as_tensor(np.stack([np.stack([s[key] for s in row])
                                              for row in samples]),
                                    device=dev)
               for key in ("tokens", "loss_mask")}
    state = {"inner_opt": stack_clients([inner.init(theta)] * 2),
             "outer_opt": outer.init(theta)}
    kernels.reset_launch_counts()
    new, st, loss = make_fdlora_round_step(
        model, cfg, inner, outer, K, sync_personalized=True,
        compress_outer=compress)(params, theta, state, batches)
    assert kernels.launch_counts()["lora_matmul"] > 0
    assert bool(torch.isfinite(loss)) and list(st["inner_opt"]["count"]) == \
        [K, K]
    step = make_lora_train_step(model, cfg, inner)
    outs = []
    for i in range(2):
        ad, s = theta, inner.init(theta)
        for k in range(K):
            ad, s, _ = step(params, ad, s, {n: v[i, k]
                                            for n, v in batches.items()})
        outs.append(ad)
    want = tree_mean(outs)
    for (path, got), (_, w), (_, prev), *ti in zip(
            tree_leaves(new), tree_leaves(want), tree_leaves(theta),
            *(tree_leaves(o) for o in outs)):
        # the bf16 mean of bf16 pseudo-gradients: 2^-7 of the largest
        # client's, plus fp32 ulps (see chip_smoke.round_step_check)
        d = max(float((prev - t).abs().max()) for _, t in ti)
        tol = 1e-6 + (2.0 ** -6 * d if compress == "bf16" else 0.0)
        assert float((got - w).abs().max()) <= tol, path


# ---------------------------------------------------------------------------
# the MoE family on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("int8", [False, True])
def test_paged_kernels_at_dbrx_group_match_plain(dev, int8):
    """dbrx-132b's attention: H 48 over Kv 8 (G 6), head dim 128, bf16
    queries over bf16 and int8 pools: decode and a 256-token prefill
    chunk against their plain versions, the chunk also per row against
    the tile's own arithmetic."""
    gen = torch.Generator(device=dev).manual_seed(48)
    q, kp, vp, bt, lens, sc = _decode_case(gen, dev, 6, 128, 16, int8,
                                           DECODE_LENGTHS, Kv=8)
    y = paged_attention(q, kp, vp, bt, lens, **sc)
    yr = ref.paged_attention_ref(q, kp, vp, bt, lens, **sc)
    assert float((y.float() - yr.float()).abs().max()) <= _bf16_tol(yr)
    assert float(y[0].float().abs().max()) == 0.0      # empty row
    q, kp, vp, sc, vdq, bt, lens = _prefill_case(
        gen, dev, 256, 6, 16, 128, int8, [0, 5, 37, 130], H=48)
    kernels.reset_launch_counts()
    y = paged_prefill_attention(q, kp, vp, bt, lens, **sc)
    yr = ref.paged_prefill_attention_ref(q, kp, vp, bt, lens, **sc)
    assert bool(torch.isfinite(y.float()).all())
    assert float((y.float() - yr.float()).abs().max()) <= _attn_tol(yr, vdq)
    _, ratio = attn_tile.tile_errors(y, attn_tile.paged_prefill_tile_ref(
        q, kp, vp, bt, lens, **sc))
    assert ratio <= 1.0
    assert kernels.tile_counts()["paged_prefill_attention"] == {"mma": 1,
                                                                "f32": 0}


# the MoE archs' attention projections (K, N): dbrx-132b's q/o and k/v,
# kimi-k2-1t-a32b's q, k/v and o
MOE_PROJECTIONS = [(6144, 6144), (6144, 1024), (7168, 8192), (7168, 1024),
                   (8192, 7168)]


@pytest.mark.parametrize("M", [4, 1024])
@pytest.mark.parametrize("K,N", MOE_PROJECTIONS)
def test_batched_lora_at_moe_projections_matches_plain(dev, K, N, M):
    """batched_lora_matmul at the MoE cells' decode (4) and prefill (4 x
    256) rows over 4 clients, to two bf16 roundings of the plain
    version."""
    gen = torch.Generator(device=dev).manual_seed(K + N + M)
    x, w, a, b, ids, kw = _lora_case(gen, dev, M, K, N, 4, 16, "f32_bank")
    kernels.reset_launch_counts()
    y = batched_lora_matmul(x, w, a, b, ids, 2.0, **kw)
    yr = _lora_plain(x, w, a, b, ids, **kw)
    assert bool(torch.isfinite(y.float()).all())
    assert float((y.float() - yr.float()).abs().max()) <= _bf16_tol(yr)
    assert kernels.tile_counts()["batched_lora_matmul"] == {"mma": 1,
                                                             "f32": 0}


def _moe_engine(dev, arch, dtype="bfloat16", **kw):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_engine
    cfg = get_config(arch, smoke=True).with_overrides(dtype=dtype, **kw)
    return build_engine(cfg, 3, dev, seed=0, rank=8)


def test_apply_moe_on_the_card_is_bitwise_repeatable(dev):
    """dbrx-smoke's MoE layer in bf16 with a banked router adapter, at a
    capacity factor where copies drop: two calls agree bitwise (the
    combine sums each token's copies in a fixed order, no atomics)."""
    from repro_torch.models import moe
    eng = _moe_engine(dev, "dbrx-132b", moe_capacity_factor=0.25)
    lp = eng.params["layers"][0]["mlp"]
    bank = eng.registry.bank()["layers"][0]["mlp"]
    gen = torch.Generator(device=dev).manual_seed(5)
    x = _randn(gen, (4, 96, eng.cfg.d_model), dev, torch.bfloat16)
    ids = torch.tensor([0, 2, 1, 0], dtype=torch.int32, device=dev)
    kept = []
    orig = moe.dispatch
    moe.dispatch = lambda *a: kept.append(orig(*a)) or kept[-1]
    try:
        outs = [moe.apply_moe(lp, x, eng.cfg, bank, eng.scale, ids)
                for _ in range(2)]
    finally:
        moe.dispatch = orig
    assert not bool(kept[0][1].all())                   # copies dropped
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert bool(torch.isfinite(outs[0][0].float()).all())


@pytest.mark.parametrize("arch", ["dbrx-132b", "kimi-k2-1t-a32b"])
def test_moe_smoke_engine_serves_through_the_kernels(dev, arch):
    """Each MoE arch's smoke config in bf16: every serving kernel launches,
    streams with overlap on and off are bitwise equal; in fp32 a prefill
    chunk through "cuda" and through "torch" with each layer's expert ids
    pinned to the "cuda" run's agree to 1% of the largest logit."""
    from repro_torch.launch.serve import ragged_requests
    from repro_torch.models import moe
    from repro_torch.serving.engine import ServeConfig
    eng = _moe_engine(dev, arch)
    reqs = ragged_requests(4, 3, eng.cfg.vocab_size, 10, 40, seed=0)
    sc = ServeConfig(batch_size=3, max_new_tokens=5, prefill_chunk=16,
                     block_size=4, num_blocks=40)
    kernels.reset_launch_counts()
    out = [list(o) for o in eng.generate(reqs, sc)]
    assert all(kernels.launch_counts()[n] > 0 for n in kernels.SERVING)
    assert [list(o) for o in eng.generate(
        reqs, dataclasses.replace(sc, overlap=False))] == out
    eng32 = _moe_engine(dev, arch, dtype="float32")
    cfg = eng32.cfg
    B, T, bs = 3, 24, 4
    toks = torch.randint(0, cfg.vocab_size, (B, T), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    n_new = torch.tensor([T, 10, 17], dtype=torch.int32, device=dev)
    lens = torch.zeros(B, dtype=torch.int32, device=dev)
    bt = (torch.arange(B * 6, device=dev, dtype=torch.int32) + 1).reshape(B, 6)
    ids = torch.tensor([0, 1, 2], dtype=torch.int32, device=dev)
    routed, orig = [], moe._top_k_routing

    def run(backend, pinned=None):
        def routing(logits, k):
            w, i, aux = orig(logits, k)
            if pinned is not None:
                i = pinned[len(routed)]
                w = torch.softmax(logits.float(), -1).gather(1, i)
                w = w / w.sum(-1, keepdim=True)
            routed.append(i)
            return w, i, aux
        cache = eng32.model.init_paged_decode_cache(1 + B * 6, bs)
        moe._top_k_routing = routing
        try:
            logits, _ = eng32.model.prefill_step(
                eng32.params, cache, toks, lens, n_new,
                adapters=eng32.bank_for(dataclasses.replace(
                    sc, paged_backend=backend)),
                lora_scale=eng32.scale, adapter_ids=ids, block_tables=bt,
                paged_backend=backend)
        finally:
            moe._top_k_routing = orig
        return logits

    lc = run("cuda")
    ids_c = list(routed)
    routed.clear()
    lt = run("torch", ids_c)
    valid = torch.arange(T, device=dev)[None, :] < n_new[:, None]
    err = float((lc - lt).abs()[valid].max())
    assert err <= 1e-2 * float(lt.abs()[valid].max())


@pytest.mark.parametrize("arch", ["dbrx-132b", "kimi-k2-1t-a32b"])
def test_moe_rounds_do_not_wait_for_the_card(dev, arch):
    """Routing, the capacity dispatch and the combine take their shapes
    from (T, k, E) alone: every round of an MoE session runs without a call
    that waits for the stream."""
    from repro_torch.serving.engine import Request
    eng = _moe_engine(dev, arch)
    eng.generate([Request("client0", np.arange(1, 20, dtype=np.int32))],
                 _overlap_sc())                 # builds and warms up
    ses = eng.session(_overlap_sc())
    for i in range(3):
        ses.submit(Request(f"client{i}",
                           (np.arange(20 + 9 * i) * (i + 3)) % 500 + 1,
                           max_new_tokens=16))
    rounds = _rounds_without_sync(ses)
    assert sum(len(t) for _, ev, _ in rounds for _, t, _ in ev) == 3 * 16


# the SSM family's in_proj shapes (K, N): mamba2-2.7b's N of 10,576 and
# jamba-v0.1-52b's of 16,544 run 80 and 160 columns past a multiple of 256
SSM_IN_PROJ = [(2560, 10576), (4096, 16544)]


@pytest.mark.parametrize("M", [4, 1024])
@pytest.mark.parametrize("K,N", SSM_IN_PROJ)
def test_batched_lora_at_ssm_in_proj_tails_matches_plain(dev, K, N, M):
    """batched_lora_matmul at the SSM cells' in_proj, decode (4) and
    prefill (4 x 256) rows over 4 clients: the tile's column guard holds
    the N tail, to two bf16 roundings of the plain version."""
    gen = torch.Generator(device=dev).manual_seed(K + N + M)
    x, w, a, b, ids, kw = _lora_case(gen, dev, M, K, N, 4, 16, "f32_bank")
    kernels.reset_launch_counts()
    y = batched_lora_matmul(x, w, a, b, ids, 2.0, **kw)
    yr = _lora_plain(x, w, a, b, ids, **kw)
    assert bool(torch.isfinite(y.float()).all())
    assert float((y.float() - yr.float()).abs().max()) <= _bf16_tol(yr)
    tail = slice(N // 256 * 256, N)
    assert float((y[:, tail].float() - yr[:, tail].float()).abs().max()) \
        <= _bf16_tol(yr)
    assert kernels.tile_counts()["batched_lora_matmul"] == {"mma": 1,
                                                             "f32": 0}


def _ssm_engine(dev, arch, dtype="bfloat16"):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_engine
    cfg = get_config(arch, smoke=True).with_overrides(dtype=dtype)
    return build_engine(cfg, 3, dev, seed=0, rank=8)


def test_mamba2_smoke_engine_serves_through_the_kernels(dev):
    """mamba2-smoke: in bf16 batched LoRA launches on its tensor-core tile
    and streams with overlap on and off are bitwise equal; in fp32 each
    request's stream through "cuda" equals the "torch" backend's first
    greedy token and the first prefill chunk's logits agree to 1% of the
    largest."""
    from repro_torch.launch.serve import ragged_requests
    from repro_torch.serving.engine import ServeConfig
    eng = _ssm_engine(dev, "mamba2-2.7b")
    reqs = ragged_requests(5, 3, eng.cfg.vocab_size, 10, 40, seed=0)
    sc = ServeConfig(batch_size=3, max_new_tokens=5, prefill_chunk=16,
                     block_size=4)
    kernels.reset_launch_counts()
    out = [list(o) for o in eng.generate(reqs, sc)]
    assert kernels.launch_counts()["batched_lora_matmul"] > 0
    assert kernels.tile_counts()["batched_lora_matmul"]["f32"] == 0
    assert [list(o) for o in eng.generate(
        reqs, dataclasses.replace(sc, overlap=False))] == out
    eng32 = _ssm_engine(dev, "mamba2-2.7b", dtype="float32")
    got = eng32.generate(reqs, sc)
    want = eng32.generate(reqs, dataclasses.replace(sc,
                                                    paged_backend="torch"))
    assert [o[0] for o in got] == [o[0] for o in want]
    lc = _next_logits(eng32, reqs[0], [], sc, "cuda")
    lt = _next_logits(eng32, reqs[0], [], sc, "torch")
    assert float((lc - lt).abs().max()) <= 1e-2 * float(lt.abs().max())


def test_jamba_smoke_engine_serves_through_the_kernels(dev):
    """jamba-smoke (mamba, MoE and attention layers) in bf16: every serving
    kernel launches and streams with overlap on and off are bitwise
    equal."""
    from repro_torch.launch.serve import ragged_requests
    from repro_torch.serving.engine import ServeConfig
    eng = _ssm_engine(dev, "jamba-v0.1-52b")
    reqs = ragged_requests(5, 3, eng.cfg.vocab_size, 10, 40, seed=0)
    sc = ServeConfig(batch_size=3, max_new_tokens=5, prefill_chunk=16,
                     block_size=4)
    kernels.reset_launch_counts()
    out = [list(o) for o in eng.generate(reqs, sc)]
    assert all(kernels.launch_counts()[n] > 0 for n in kernels.SERVING)
    assert [list(o) for o in eng.generate(
        reqs, dataclasses.replace(sc, overlap=False))] == out


def test_ssm_rounds_do_not_wait_for_the_card(dev):
    """The recurrence steps on shapes known on the host: every round of a
    mamba2-smoke session runs without a call that waits for the stream."""
    from repro_torch.serving.engine import Request
    eng = _ssm_engine(dev, "mamba2-2.7b")
    eng.generate([Request("client0", np.arange(1, 20, dtype=np.int32))],
                 _overlap_sc())                 # builds and warms up
    ses = eng.session(_overlap_sc())
    for i in range(3):
        ses.submit(Request(f"client{i}",
                           (np.arange(20 + 9 * i) * (i + 3)) % 500 + 1,
                           max_new_tokens=16))
    rounds = _rounds_without_sync(ses)
    assert sum(len(t) for _, ev, _ in rounds for _, t, _ in ev) == 3 * 16


# ---------------------------------------------------------------------------
# training on the MoE base and the torch examples on the card
# ---------------------------------------------------------------------------

def test_moe_expert_bmm_has_a_backward_on_the_card(dev):
    """``moe._bmm_f32`` (``aten::bmm.dtype``, bf16 in, fp32 out) has no
    autograd formula in torch; the port's backward gives the plain fp32
    product's gradient but for one bf16 rounding of the output gradient
    (relative 2^-9 an element) and the final rounding to bf16, which both
    sides make in another order: ``_bf16_tol``."""
    from repro_torch.models.moe import _bmm_f32
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((4, 64, 96), generator=g, device=dev).to(torch.bfloat16)
    b = torch.randn((4, 96, 80), generator=g, device=dev).to(torch.bfloat16)
    dy = torch.randn((4, 64, 80), generator=g, device=dev)
    a1 = a.clone().requires_grad_(True)
    out = _bmm_f32(a1, b)
    assert out.dtype == torch.float32
    (ga,) = torch.autograd.grad(out, a1, dy)
    a2 = a.clone().requires_grad_(True)
    (gr,) = torch.autograd.grad(torch.bmm(a2.float(), b.float()), a2, dy)
    assert ga.dtype == torch.bfloat16
    torch.testing.assert_close(ga.float(), gr.float(), rtol=0.0,
                               atol=_bf16_tol(gr))


def test_moe_expert_bmm_weight_gradient_on_the_card(dev):
    """Full fine-tuning asks ``moe._bmm_f32`` for the expert stack's
    gradient too (``needs_input_grad[1]``): the plain fp32 product's, but
    for the bf16 rounding of the output gradient and of the result
    (``_bf16_tol``), in the stack's dtype, and none for a frozen input."""
    from repro_torch.models.moe import _bmm_f32
    g = torch.Generator(device=dev).manual_seed(1)
    a = torch.randn((4, 64, 96), generator=g, device=dev).to(torch.bfloat16)
    b = torch.randn((4, 96, 80), generator=g, device=dev).to(torch.bfloat16)
    dy = torch.randn((4, 64, 80), generator=g, device=dev)
    a1, b1 = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    ga, gb = torch.autograd.grad(_bmm_f32(a1, b1), (a1, b1), dy)
    a2, b2 = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    ra, rb = torch.autograd.grad(torch.bmm(a2.float(), b2.float()), (a2, b2),
                                 dy)
    assert ga.dtype == gb.dtype == torch.bfloat16
    torch.testing.assert_close(ga.float(), ra.float(), rtol=0.0,
                               atol=_bf16_tol(ra))
    torch.testing.assert_close(gb.float(), rb.float(), rtol=0.0,
                               atol=_bf16_tol(rb))
    (only_b,) = torch.autograd.grad(_bmm_f32(a, b1), b1, dy)
    torch.testing.assert_close(only_b, gb, rtol=0.0, atol=0.0)


FULL_STEP_ARCHS = ["llama2-7b", "gemma-2b", "dbrx-132b", "mamba2-2.7b",
                   "jamba-v0.1-52b", "internvl2-26b", "whisper-small"]


@pytest.mark.parametrize("arch", FULL_STEP_ARCHS)
def test_full_train_step_runs_through_flash_attention(dev, arch):
    """``make_full_train_step`` on each family's smoke config in bf16 on
    "cuda": every weight's gradient against "torch" within the bf16
    bounds chip_smoke.py's train phases use (loss 2e-2, each leaf 0.25
    relative), flash attention in every attention layer and no LoRA
    kernel (their backwards refuse a gradient for the base weight), then
    one AdamW step with finite weights in their dtypes."""
    from repro_torch.configs import get_config
    from repro_torch.core.lora import tree_leaves
    from repro_torch.models.api import Model
    from repro_torch.training.optimizers import adamw
    from repro_torch.training.train_step import (full_value_and_grad,
                                                 make_full_train_step)
    cfg = get_config(arch, smoke=True)
    model = Model(cfg, dev)
    params = model.init(0)
    g = torch.Generator(device=dev).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=g,
                           device=dev, dtype=torch.int32)
    batch = {"tokens": tokens, "loss_mask": torch.ones_like(tokens)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn(
            (2, cfg.n_patch_tokens, cfg.d_model), generator=g, device=dev)
    if cfg.is_encdec:
        batch["enc_embeds"] = torch.randn(
            (2, cfg.encoder_seq_len, cfg.d_model), generator=g, device=dev)
    out = {}
    for backend in ("cuda", "torch"):
        kernels.reset_launch_counts()
        loss, _, grads = full_value_and_grad(model, cfg, backend)(params,
                                                                  batch)
        out[backend] = (float(loss), dict(tree_leaves(grads)),
                        kernels.launch_counts())
    (lc, gc, nc), (lt, gt, nt) = out["cuda"], out["torch"]
    assert abs(lc - lt) <= 2e-2 * abs(lt)
    assert gc.keys() == gt.keys() == {p for p, _ in tree_leaves(params)}
    for p, ref_g in gt.items():
        assert gc[p].dtype == ref_g.dtype and bool(torch.isfinite(gc[p]).all())
        err = torch.linalg.vector_norm((gc[p] - ref_g).float())
        assert float(err) <= 0.25 * float(
            torch.linalg.vector_norm(ref_g.float())) + 1e-30, p
    n_attn = (2 * cfg.n_layers if cfg.is_encdec else
              sum(cfg.layer_entry(i).startswith("attn")
                  for i in range(cfg.n_layers)))
    assert nc["flash_attention"] >= n_attn and not any(nt.values())
    assert all(nc[n] == 0 for n in kernels.WRAPPERS if n != "flash_attention")
    opt = adamw()
    new, st, metrics = make_full_train_step(model, cfg, opt,
                                            paged_backend="cuda")(
        params, opt.init(params), batch)
    assert st["count"] == 1 and bool(torch.isfinite(metrics["loss"]))
    for (p, t), (_, t0) in zip(tree_leaves(new), tree_leaves(params)):
        assert t.dtype == t0.dtype and bool(torch.isfinite(t).all()), p


def test_moe_train_step_runs_through_the_kernels(dev):
    """A dbrx-smoke LoRA train step on "cuda": finite loss and gradients
    for every adapter leaf, the router's pair included."""
    from repro_torch.configs import get_config
    from repro_torch.core.lora import init_adapters, tree_leaves
    from repro_torch.models.api import Model
    from repro_torch.training.train_step import lora_value_and_grad
    cfg = get_config("dbrx-132b", smoke=True)
    model = Model(cfg, dev)
    params = model.init(0)
    ad = init_adapters(cfg, seed=1, device=dev, b_std=0.02)
    tokens = torch.arange(64, device=dev, dtype=torch.int32).reshape(2, 32)
    batch = {"tokens": tokens % cfg.vocab_size,
             "loss_mask": torch.ones_like(tokens)}
    kernels.reset_launch_counts()
    loss, _, grads = lora_value_and_grad(model, cfg, "cuda")(params, ad,
                                                             batch)
    assert kernels.launch_counts()["lora_matmul"] > 0
    assert bool(torch.isfinite(loss))
    leaves = dict(tree_leaves(grads))
    assert any("router" in p for p in leaves)
    assert all(bool(torch.isfinite(g).all()) for g in leaves.values())


def test_torch_quickstart_runs_through_the_kernels(dev):
    """``examples/torch_quickstart.py`` on the card: its train steps launch
    the LoRA and flash-attention kernels, its losses stay finite."""
    import importlib.util
    import math
    from pathlib import Path
    path = (Path(__file__).resolve().parents[1] / "examples"
            / "torch_quickstart.py")
    spec = importlib.util.spec_from_file_location("torch_quickstart", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    kernels.reset_launch_counts()
    out = mod.main(["--steps", "3", "--device", "cuda"])
    counts = kernels.launch_counts()
    assert counts["lora_matmul"] > 0 and counts["flash_attention"] > 0
    assert all(math.isfinite(x) for x in out["losses"])
    assert out["tokens"].shape == (1, 4)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compress", ["none", "bf16"])
def test_mesh_round_at_world_one_is_bitwise_the_meshless_round(dev,
                                                               compress):
    """``make_fdlora_round_step(mesh=...)`` on a one-rank NCCL group (the
    mesh factory starts it over a HashStore): θ_s', every client's state
    and the loss bitwise those of the meshless round, through the LoRA
    and flash-attention kernels; one pod all-reduce a round."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.federated.mesh_job import Case, RoundJob, run
    cfg = get_config("llama2-7b", smoke=True)
    job = RoundJob(cfg, [Case(pod=None, compress=compress, sync=True),
                         Case(pod=1, compress=compress, sync=True)],
                   clients=2, inner_steps=2, rows=4, seq=128, rounds=2,
                   device="cuda", return_trees=False)
    running = dist.is_initialized()
    try:
        ref, got = run(job)
    finally:
        if not running and dist.is_initialized():
            dist.destroy_process_group()
    assert got["loss"] == ref["loss"] and got["digest"] == ref["digest"]
    assert got["client_digests"] == ref["client_digests"]
    assert got["outer_digest"] == ref["outer_digest"]
    assert got["launches"]["lora_matmul"] > 0
    assert got["launches"]["flash_attention"] > 0
    assert [[c["axis"] for c in log] for log in got["collectives"]] == \
        [["pod"], ["pod"]]
