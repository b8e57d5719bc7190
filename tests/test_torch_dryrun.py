"""The dry run on the meta device (``launch/dryrun.py``) and the kernels'
meta routes (``kernels/meta.py``), on the CPU.

Each kernel wrapper on meta tensors returns the shapes and dtypes its
plain version returns on the CPU, and records FLOPs and bytes equal to a
hand count (attended pairs counted from a mask) at two shapes each; the
dry run's ``argument_bytes`` equal the summed bytes of the real CPU trees
of every smoke arch; a forward's FLOPs equal a hand count; counts at
depth 1, 2 and 3 differ by a constant per layer; full-width parameter
bytes on meta reproduce the depth cuts the card runs; a prefill walk
launches flash attention and holds no (B, H, S, S) scores; every
supported arch × {decode_32k, train_4k} writes a JSON with the stated
keys (smoke widths), whisper-small × long_500k is skipped, and the CLI's
refusals; ``--mesh 2,16,16`` (the reference's multi-pod mesh) at llama2-7b's full
width; the torch examples on the CPU.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.registry import ALL_ARCHS, shape_supported
from repro_torch.core.lora import init_adapters
from repro_torch.kernels import (batched_dual_lora_matmul,
                                 batched_lora_matmul, dual_lora_matmul,
                                 flash_attention, lora_matmul, meta,
                                 paged_attention, paged_prefill_attention)
from repro_torch.kernels.paged_attention import SPLIT
from repro_torch.kernels.paged_prefill import paged_scatter
from repro_torch.launch import dryrun
from repro_torch.models.api import Model
from repro_torch.training.optimizers import adamw

BF16, F32 = torch.bfloat16, torch.float32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The examples' CPU training runs thousands of small torch ops; with
    the suite's worker processes sharing the cores, each op's thread team
    waits for descheduled threads (the federated example took 781 s
    instead of 3 s).  One intra-op thread for this file, restored after
    it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meta(*ts):
    return [None if t is None else torch.empty_like(t, device="meta")
            for t in ts]


def _records(fn, *args, **kw):
    got = []
    with meta.recording(lambda name, cost: got.append((name, cost))):
        out = fn(*args, **kw)
    return out, got


def _same_layout(a, b):
    assert tuple(a.shape) == tuple(b.shape) and a.dtype == b.dtype
    assert a.device.type == "meta"


def _randn(shape, dtype=F32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype)


# ---------------------------------------------------------------------------
# each kernel's meta route: layout of the plain version, hand-counted cost
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,K,N,r,xd", [(64, 128, 256, 16, BF16),
                                        (40, 96, 72, 8, F32)])
def test_lora_matmul_meta_route(M, K, N, r, xd):
    x, w = _randn((M, K), xd), _randn((K, N), BF16, 1)
    a, b = _randn((K, r), F32, 2), _randn((r, N), F32, 3)
    ref = lora_matmul(x, w, a, b, 2.0)
    out, rec = _records(lora_matmul, *_meta(x, w, a, b), 2.0)
    _same_layout(out, ref)
    (name, c), = rec
    el = x.element_size()
    assert name == "lora_matmul"
    assert c.flops == 2 * M * K * N + 2 * M * r * K + 2 * M * r * N
    assert c.bytes_read == el * M * K + 2 * K * N + 4 * K * r + 4 * r * N
    assert c.bytes_written == el * M * N + 4 * M * r      # y, and z kept


def test_lora_matmul_meta_backward_is_plain_and_counted():
    """The backward of a meta launch runs the plain backward on meta
    tensors: gradients of the CPU shapes and dtypes, matmuls counted."""
    x = torch.empty((32, 64), dtype=BF16, device="meta", requires_grad=True)
    w = torch.empty((64, 48), dtype=BF16, device="meta")
    a = torch.empty((64, 8), device="meta", requires_grad=True)
    b = torch.empty((8, 48), device="meta", requires_grad=True)
    res = dryrun.measure(lambda: torch.autograd.grad(
        lora_matmul(x, w, a, b, 2.0).float().sum(), (x, a, b)),
        {"inputs": (x, w, a, b)})
    assert res["kernels"]["lora_matmul"]["launches"] == 1
    # dz = dy·Bᵀ, dB = zᵀ·dy, dA = xᵀ·dz, dx = dy·Wᵀ + dz·Aᵀ
    assert res["counts"]["op_flops"] == 2 * (32 * 48 * 8 + 8 * 32 * 48
                                             + 64 * 32 * 8 + 32 * 48 * 64
                                             + 32 * 8 * 64)


@pytest.mark.parametrize("M,K,N,C,r,xd", [(48, 64, 96, 4, 16, BF16),
                                          (3, 128, 64, 8, 8, F32)])
def test_batched_lora_meta_route(M, K, N, C, r, xd):
    x, w = _randn((M, K), xd), _randn((K, N), BF16, 1)
    a, b = _randn((C, K, r), F32, 2), _randn((C, r, N), F32, 3)
    ids = torch.arange(M, dtype=torch.int32) % C
    ref = batched_lora_matmul(x, w, a, b, ids, 2.0)
    out, ((name, c),) = _records(batched_lora_matmul,
                                 *_meta(x, w, a, b, ids), 2.0)
    _same_layout(out, ref)
    el, active = x.element_size(), min(C, M)
    assert name == "batched_lora_matmul"
    assert c.flops == 2 * M * K * N + 2 * M * r * (K + N)
    assert c.bytes_read == (el * M * K + 2 * K * N + 4 * M
                            + active * 4 * r * (K + N))
    assert c.bytes_written == el * M * N
    assert c.scratch_bytes >= 4 * M * r               # z at least


@pytest.mark.parametrize("M,K,N,r,xd", [(64, 128, 256, 16, BF16),
                                        (5, 64, 40, 4, F32)])
def test_dual_lora_meta_route(M, K, N, r, xd):
    x, w = _randn((M, K), xd), _randn((K, N), BF16, 1)
    a1, a2 = _randn((K, r), F32, 2), _randn((K, r), F32, 3)
    b1, b2 = _randn((r, N), F32, 4), _randn((r, N), F32, 5)
    fw = torch.tensor([0.6, 0.4])
    ref = dual_lora_matmul(x, w, a1, b1, a2, b2, fw, 2.0)
    with torch.no_grad():
        out, ((name, c),) = _records(dual_lora_matmul,
                                     *_meta(x, w, a1, b1, a2, b2, fw), 2.0)
    _same_layout(out, ref)
    el = x.element_size()
    assert c.flops == 2 * M * K * N + 2 * M * r * (K + N) + 3 * r * (K + N)
    assert c.bytes_read == el * M * K + 2 * K * N + 2 * 4 * r * (K + N) + 8
    assert c.bytes_written == el * M * N


@pytest.mark.parametrize("M,K,N,C,r,xd", [(16, 64, 32, 3, 8, BF16),
                                          (2, 32, 48, 4, 4, F32)])
def test_batched_dual_lora_meta_route(M, K, N, C, r, xd):
    x, w = _randn((M, K), xd), _randn((K, N), BF16, 1)
    a1, b1 = _randn((C, K, r), F32, 2), _randn((C, r, N), F32, 3)
    a2, b2 = _randn((K, r), F32, 4), _randn((r, N), F32, 5)
    ids = torch.arange(M, dtype=torch.int32) % C
    fw = _randn((M, 2), F32, 6)
    ref = batched_dual_lora_matmul(x, w, a1, b1, a2, b2, ids, fw, 2.0)
    out, ((_, c),) = _records(batched_dual_lora_matmul,
                              *_meta(x, w, a1, b1, a2, b2, ids, fw), 2.0)
    _same_layout(out, ref)
    el = x.element_size()
    assert c.flops == 2 * M * K * N + 4 * M * r * (K + N)
    assert c.bytes_read == (el * M * K + 2 * K * N
                            + 4 * (min(C, M) + 1) * r * (K + N) + 12 * M)
    assert c.bytes_written == el * M * N


def _pairs(Sq, Sk, causal, window):
    q = np.arange(Sq)[:, None] + (Sk - Sq)
    k = np.arange(Sk)[None, :]
    mask = np.ones((Sq, Sk), bool)
    if causal:
        mask &= k <= q
    if window:
        mask &= k > q - window
    return int(mask.sum())


@pytest.mark.parametrize("B,H,Kv,Sq,Sk,d,causal,window,dt", [
    (2, 8, 2, 32, 32, 64, True, 0, BF16),
    (1, 4, 4, 12, 40, 32, True, 9, F32),
    (2, 4, 1, 7, 50, 32, False, 0, BF16)])
def test_flash_attention_meta_route(B, H, Kv, Sq, Sk, d, causal, window, dt):
    q, k, v = (_randn((B, H, Sq, d), dt), _randn((B, Kv, Sk, d), dt, 1),
               _randn((B, Kv, Sk, d), dt, 2))
    ref = flash_attention(q, k, v, causal=causal, sliding_window=window)
    out, ((name, c),) = _records(flash_attention, *_meta(q, k, v),
                                 causal=causal, sliding_window=window)
    _same_layout(out, ref)
    el = q.element_size()
    assert name == "flash_attention"
    assert c.flops == 4 * d * B * H * _pairs(Sq, Sk, causal, window)
    assert c.bytes_read == el * (B * H * Sq * d + 2 * B * Kv * Sk * d)
    assert c.bytes_written == el * B * H * Sq * d


def _pools(NB, bs, Kv, hd):
    return _randn((NB, bs, Kv, hd), BF16, 7), _randn((NB, bs, Kv, hd), BF16, 8)


@pytest.mark.parametrize("B,H,Kv,hd,bs,MB,window", [
    (3, 8, 2, 64, 16, 4, 0), (2, 4, 4, 32, 16, 20, 100)])
def test_paged_attention_meta_route(B, H, Kv, hd, bs, MB, window):
    kp, vp = _pools(1 + B * MB, bs, Kv, hd)
    q = _randn((B, H, hd), BF16, 9)
    bt = (1 + torch.arange(B * MB, dtype=torch.int32)).reshape(B, MB)
    lens = torch.full((B,), MB * bs, dtype=torch.int32)
    ref = paged_attention(q, kp, vp, bt, lens, sliding_window=window)
    out, ((name, c),) = _records(paged_attention,
                                 *_meta(q, kp, vp, bt, lens),
                                 sliding_window=window)
    _same_layout(out, ref)
    ctx = B * (min(MB * bs, window) if window else MB * bs)   # full tables
    assert c.flops == 4 * hd * H * ctx
    assert c.bytes_read == 2 * 2 * ctx * Kv * hd + 2 * B * H * hd \
        + 4 * B * (MB + 1)
    assert c.bytes_written == 2 * B * H * hd
    NS = -(-MB * bs // SPLIT)
    assert c.scratch_bytes == (4 * B * H * NS * (hd + 2) if NS > 1 else 0)


@pytest.mark.parametrize("B,T,H,Kv,hd,bs,MB,window", [
    (2, 8, 8, 2, 64, 16, 3, 0), (1, 16, 4, 4, 32, 8, 6, 10)])
def test_paged_prefill_and_scatter_meta_routes(B, T, H, Kv, hd, bs, MB,
                                               window):
    kp, vp = _pools(1 + B * MB, bs, Kv, hd)
    q = _randn((B, T, H, hd), BF16, 9)
    kn, vn = _randn((B, T, Kv, hd), BF16, 10), _randn((B, T, Kv, hd), BF16, 11)
    bt = (1 + torch.arange(B * MB, dtype=torch.int32)).reshape(B, MB)
    n = MB * bs - T                    # each chunk at the end of its table
    lens = torch.full((B,), n, dtype=torch.int32)
    ref = paged_prefill_attention(q, kp, vp, bt, lens, sliding_window=window)
    mkp, mvp = _meta(kp, vp)
    (rk, rv), ((sname, sc),) = _records(paged_scatter, mkp, mvp,
                                        *_meta(kn, vn, bt, lens))
    assert rk is mkp and rv is mvp and sname == "paged_scatter"
    assert sc.bytes_read == sc.bytes_written == 2 * 2 * B * T * Kv * hd
    out, ((name, c),) = _records(paged_prefill_attention,
                                 *_meta(q, kp, vp, bt, lens),
                                 sliding_window=window)
    _same_layout(out, ref)
    W = window or 10 ** 9
    pairs = sum(min(n + t + 1, W) for t in range(T))
    ctx = n + T - max(0, n - W + 1)
    assert c.flops == 4 * hd * H * B * pairs
    assert c.bytes_read == (2 * 2 * B * ctx * Kv * hd + 2 * B * T * H * hd
                            + 4 * B * (MB + 1))
    assert c.bytes_written == 2 * B * T * H * hd


# ---------------------------------------------------------------------------
# the dry run on small configs
# ---------------------------------------------------------------------------

def _nbytes(*trees):
    return sum(t.numel() * t.element_size() for t in dryrun.iter_tensors(trees))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_argument_bytes_equal_the_real_cpu_trees(arch):
    cfg = get_config(arch, smoke=True)
    B, S = 2, 16
    res = dryrun.dry_run(cfg.with_overrides(paged_backend="cuda"), "train",
                         B, S)
    params = Model(cfg, "cpu").init(0)
    ad = init_adapters(cfg, device="cpu")
    st = adamw().init(ad)
    batch = {k: torch.zeros((B, S), dtype=torch.int32)
             for k in ("tokens", "loss_mask")}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.zeros(
            (B, cfg.n_patch_tokens, cfg.d_model), dtype=BF16)
    if cfg.is_encdec:
        batch["enc_embeds"] = torch.zeros(
            (B, cfg.encoder_seq_len, cfg.d_model), dtype=BF16)
    by = res["memory"]["argument_bytes_by"]
    assert by == {"params": _nbytes(params), "adapters": _nbytes(ad),
                  "opt_state": _nbytes(st), "inputs": _nbytes(batch)}
    assert res["memory"]["argument_bytes"] == _nbytes(params, ad, st, batch)
    assert res["memory"]["peak_bytes"] > res["memory"]["argument_bytes"]


def test_decode_cache_bytes_equal_the_real_cpu_cache():
    cfg = get_config("jamba-v0.1-52b", smoke=True)
    res = dryrun.dry_run(cfg, "decode", 3, 24)
    cache = Model(cfg, "cpu").init_decode_cache(3, 24)
    assert res["memory"]["argument_bytes_by"]["cache"] == _nbytes(cache)


def _proj_flops(M, K, N, r):
    return 2 * M * K * N + 2 * M * r * (K + N)


def test_forward_flops_equal_a_hand_count():
    """llama2-smoke prefill: 7 LoRA projections and one causal flash call
    a layer, the last position's unembedding; nothing else multiplies."""
    cfg = get_config("llama2-7b", smoke=True)
    B, S = 2, 16
    d, ff, V, r = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.lora_rank
    H, Kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    M = B * S
    per_layer = (_proj_flops(M, d, H * hd, r)
                 + 2 * _proj_flops(M, d, Kv * hd, r)
                 + _proj_flops(M, H * hd, d, r) + 2 * _proj_flops(M, d, ff, r)
                 + _proj_flops(M, ff, d, r)
                 + 4 * hd * B * H * S * (S + 1) // 2)
    want = cfg.n_layers * per_layer + 2 * B * d * V
    res = dryrun.dry_run(cfg, "prefill", B, S)
    assert res["roofline"]["flops"] == want
    assert res["counts"]["op_flops"] == 2 * B * d * V
    assert res["kernels"]["lora_matmul"]["launches"] == 7 * cfg.n_layers
    assert res["kernels"]["flash_attention"]["launches"] == cfg.n_layers


@pytest.mark.parametrize("arch,step", [("llama2-7b", "train"),
                                       ("dbrx-132b", "prefill"),
                                       ("mamba2-2.7b", "train"),
                                       ("olmo-1b", "decode")])
def test_counts_grow_by_a_constant_per_layer(arch, step):
    base = get_config(arch, smoke=True)

    def counts(L):
        r = dryrun.dry_run(base.with_overrides(n_layers=L), step, 2, 16)
        return np.array([r["roofline"]["flops"], r["counts"]["op_bytes"],
                         r["counts"]["kernel_bytes"],
                         r["memory"]["argument_bytes"],
                         sum(k["launches"] for k in r["kernels"].values())])
    c1, c2, c3 = counts(1), counts(2), counts(3)
    assert (c2 - c1 > 0).all()
    np.testing.assert_array_equal(c3 - c2, c2 - c1)


@pytest.mark.parametrize("arch,layers,gb", [("dbrx-132b", 8, 54.6),
                                            ("kimi-k2-1t-a32b", 1, 38.8),
                                            ("jamba-v0.1-52b", 8, 26.5),
                                            ("internvl2-26b", 48, 39.72)])
def test_full_width_parameter_bytes_on_meta(arch, layers, gb):
    """The depth cuts the card runs (PERF.md §4), from the meta tree."""
    cfg = get_config(arch).with_overrides(n_layers=layers)
    params = Model(cfg, "meta").init()
    got = dryrun.storage_bytes(params)
    assert got == _nbytes(params)
    assert round(got / 1e9, 2 if gb == 39.72 else 1) == gb


def test_prefill_walk_takes_the_kernels_and_forms_no_scores():
    """At 4,096 tokens the plain path's fp32 scores of one layer, B·H·S²,
    would exceed everything else the walk holds."""
    cfg = get_config("llama2-7b", smoke=True)
    B, S = 1, 4096
    res = dryrun.dry_run(cfg, "prefill", B, S)
    scores = 4 * B * cfg.n_heads * S * S
    assert res["kernels"]["flash_attention"]["launches"] == cfg.n_layers
    assert res["memory"]["temp_bytes"] < scores // 8


def test_paged_serving_steps_walk_the_kernels_on_meta():
    """The paged branch takes its "cuda" route on meta tensors: a prefill
    chunk scatters and runs the prefill kernel, a decode step scatters and
    runs the decode kernel, each projection the batched LoRA kernel."""
    cfg = get_config("yi-6b", smoke=True)
    model = Model(cfg, "meta")
    params = model.init()
    bank = {"layers": [{part: {t: {k: torch.stack([v] * 3)
                                   for k, v in pair.items()}
                               for t, pair in tm.items()}
                        for part, tm in layer.items()}
                       for layer in init_adapters(cfg, device="meta")
                       ["layers"]]}
    cache = model.init_paged_decode_cache(9, 4)
    B, T = 2, 8

    def mint(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")

    ids, bt = mint(B), mint(B, 4)
    res = dryrun.measure(lambda: (
        model.prefill_step(params, cache, mint(B, T), mint(B), mint(B),
                           adapters=bank, adapter_ids=ids, block_tables=bt),
        model.decode_step(params, cache, mint(B, 1), mint(B), adapters=bank,
                          adapter_ids=ids, block_tables=bt)),
        {"params": params, "cache": cache})
    k = res["kernels"]
    L = cfg.n_layers
    assert k["paged_prefill_attention"]["launches"] == L
    assert k["paged_attention"]["launches"] == L
    assert k["paged_scatter"]["launches"] == 2 * L
    assert k["batched_lora_matmul"]["launches"] == 2 * 7 * L


KEYS = {"arch", "shape", "mesh", "step", "variant", "chips", "params",
        "active_params", "lora_params", "memory", "roofline", "device",
        "kernels", "counts", "fits", "walk_s"}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_arch_writes_its_json(arch, tmp_path):
    # smoke widths, but whisper-small in full: its smoke config's 64
    # learned decoder positions cannot hold train_4k's 4,096 tokens
    smoke = arch != "whisper-small"
    for shape in ("decode_32k", "train_4k"):
        assert shape_supported(arch, shape)
        r = dryrun.run_one(arch, shape, out_dir=str(tmp_path), smoke=smoke)
        assert KEYS <= set(r) and r["chips"] == 1 and r["mesh"] == "1xh100"
        assert {"argument_bytes", "peak_bytes", "temp_bytes",
                "output_bytes"} <= set(r["memory"])
        tag = f"{arch}__{shape}__1xh100__{r['step']}" + (
            "__smoke" if smoke else "")
        on_disk = json.loads((tmp_path / f"{tag}.json").read_text())
        assert on_disk["memory"] == r["memory"]
        assert r["roofline"]["flops"] > 0 and r["roofline"]["hbm_bytes"] > 0
        assert r["device"]["memory_bytes"] > 0


def test_cli_runs_skips_and_refuses(tmp_path, capsys):
    out = str(tmp_path)
    assert dryrun.main(["--arch", "whisper-small", "--shape", "long_500k",
                        "--out-dir", out]) == 0
    assert "SKIP whisper-small long_500k" in capsys.readouterr().out
    assert dryrun.main(["--arch", "dbrx-132b", "--shape", "decode_32k",
                        "--smoke", "--variant", "moe_cap1",
                        "--out-dir", out]) == 0
    assert (tmp_path / "dbrx-132b__decode_32k__1xh100__decode__moe_cap1"
            "__smoke.json").exists()
    for bad in (["--variant", "gqa_grouped"], ["--variant", "nope"]):
        with pytest.raises(SystemExit):
            dryrun.main(["--arch", "olmo-1b", "--shape", "decode_32k",
                         "--out-dir", out] + bad)
    # serving over the production mesh walks one rank's decode step
    assert dryrun.main(["--arch", "olmo-1b", "--shape", "decode_32k",
                        "--mesh", "2,16,16", "--step", "decode",
                        "--out-dir", out]) == 0
    r = json.loads((tmp_path / "olmo-1b__decode_32k__2x16x16__decode.json")
                   .read_text())
    assert r["chips"] == 512 and r["per_rank"] and r["collectives"]
    with pytest.raises(ValueError, match="XLA"):
        dryrun.run_one("olmo-1b", "decode_32k", variant="sm_bf16",
                       out_dir=out)


def test_cli_multi_pod_walks_one_rank_of_the_production_mesh(tmp_path,
                                                             capsys):
    """llama2-7b's train step at full width on one rank of (2, 16, 16):
    per-rank memory, the roofline over 512 cards and the collective log.
    Without recomputation (``no_remat``) per layer two sums forward and
    two backward over "model"; at the default (``remat`` "full") the
    recomputed forward issues the attention's sum again, and stops before
    the MLP's, whose output no backward reads; one gradient all-reduce
    over "data" then "pod".  gemma-2b is skipped, naming its head
    count."""
    out = str(tmp_path)
    act = 8 * 4096 * 4096 * 2        # 8 rows a rank, bf16 activations
    peaks = {}
    for variant, sums in (("no_remat", 4 * 32 + 1), ("baseline", 5 * 32 + 1)):
        assert dryrun.main(["--arch", "llama2-7b", "--shape", "train_4k",
                            "--mesh", "2,16,16", "--step", "train",
                            "--variant", variant, "--out-dir", out]) == 0
        tag = "" if variant == "baseline" else f"__{variant}"
        r = json.loads((tmp_path / f"llama2-7b__train_4k__2x16x16__train"
                                   f"{tag}.json").read_text())
        assert r["remat"] == (variant == "baseline")
        assert r["mesh_shape"] == {"pod": 2, "data": 16, "model": 16}
        assert r["chips"] == r["roofline"]["chips"] == 512
        assert 0 < r["memory"]["argument_bytes"] < r["memory"]["peak_bytes"]
        by = {}
        for c in r["collectives"]:
            by.setdefault((c["axis"], c["group"]), []).append(c["bytes"])
        assert by[("model", 16)].count(act) == sums
        assert len(by[("data", 16)]) == len(by[("pod", 2)]) == 2
        assert r["roofline"]["collective_s"] > 0
        assert "OK llama2-7b train_4k 2x16x16 train" in capsys.readouterr().out
        peaks[variant] = r["memory"]["peak_bytes"]
    assert peaks["baseline"] < peaks["no_remat"]
    assert dryrun.main(["--arch", "gemma-2b", "--shape", "train_4k",
                        "--mesh", "2,16,16", "--out-dir", out]) == 0
    assert "n_heads 8 does not divide" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the torch examples on the CPU, at a few steps
# ---------------------------------------------------------------------------

def _example(name):
    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_torch_quickstart_runs_on_the_cpu():
    out = _example("torch_quickstart").main(["--steps", "3", "--device", "cpu"])
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert 0.0 <= out["accuracy"] <= 1.0 and out["tokens"].shape == (1, 4)


def test_torch_serve_fused_runs_on_the_cpu():
    out = _example("torch_serve_fused").main(["--device", "cpu"])
    assert out["tokens"].shape == (2, 4)
    # bf16 output rounding of the plain dual-LoRA version
    assert out["kernel_err"] <= 2 ** -7 * out["max_abs_ref"]


def test_torch_federated_log_analysis_runs_on_the_cpu():
    out = _example("torch_federated_log_analysis").main(
        ["--device", "cpu", "--clients", "2", "--rounds", "1"])
    assert len(out) == 2
    assert all(0.0 <= c["accuracy"] <= 1.0 and c["comm_mib"] > 0
               for c in out)
