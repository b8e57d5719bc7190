#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card and check it end to end.

    python3 chip_smoke.py            # from the root of a checkout

Phases (each prints one JSON line per result):
  1. build   — compile every CUDA kernel of the port from
               src/repro_torch/kernels/csrc (one nvcc per source, in parallel);
  2. kernels — hold each kernel against its plain PyTorch version on the card
               at its path's shapes and variants (serving: bf16 and int8 K/V,
               GQA groups 1 and 4, ragged lengths with an empty row, the
               split-K decode kernel also at gemma-2b's and starcoder2's
               decode shapes, with its splits and launches, prefill at
               gemma-2b's head dim 256 (bf16 and int8 pools), decode and
               prefill at starcoder2-15b's shape under its 4096-token
               sliding window with contexts to 6144, decode and prefill at
               yi-6b's G 8 and dbrx-132b's G 6, batched LoRA at every other
               dense arch's and the MoE archs' attention projection shapes
               and rows, rank
               mask, int8 bank, and the per-row Eq. 7 batched dual-LoRA
               product at its entry point; training: the LoRA and dual-LoRA
               products of a 2048-row batch, flash attention at B=8, S=256
               with a window, Sq < Sk and GQA variants and at gemma-2b's
               head dim 256, the LoRA product at gemma-2b's train-step
               projections, at the fixed path's 8 decode rows and at the
               baselines' ranks 8 and 32, and the two
               autograd backwards against plain autograd); the two
               attention kernels and the four LoRA kernels also with fp32
               activations, which run their fp32 CUDA-core tile (bf16 runs
               the tensor-core tile), held tight, and bf16 attention and
               dual-LoRA outputs held per row to the tile's own arithmetic
               (kernels/attn_tile.py, kernels/lora_tile.py); time kernel
               (CUDA events around back-to-back calls, and
               ``device_ms``: its own device time
               per call from a torch.profiler trace), plain version and one
               library call computing the same function (a yardstick the
               port never calls; for decode also its device time); at the
               prefill shape, the LoRA shrink's
               and epilogue's share of the call's device time;
  3. serve   — llama2-7b at full width, 32 layers, bf16, random weights from
               --seed, 8 tenants with non-zero rank-16 adapters: 8 ragged
               requests (prompts 128-1024 tokens, 32 new tokens) through
               MultiTenantEngine.generate with paged_backend="cuda", counting
               kernel launches; then the same requests with "torch", holding
               first-chunk logits and greedy tokens to stated tolerances; the
               "cuda" run four times, in turns with overlapped dispatch (the
               default) and without (on, off, off, on), streams bitwise
               equal; four traced runs in the same turns;
  3b. serve_trace — the same engine under an open-loop Poisson trace
               (serving/trace.py: 16 requests at 2/s, prompts 1-1024 and
               outputs 1-64 tokens, lognormal, over the 8 tenants; 8 slots
               of 1088 tokens): logical mode (arrivals mapped to rounds)
               with overlap on and off, streams bitwise equal, some decode
               chunks deferred; realtime mode in the same four turns, with
               TTFT from the scheduled arrival, TPOT, goodput and
               wall-clock queue waits, streams held to the logical ones by
               the margin rule; one traced realtime run;
  4. serve_options — the same llama2-7b weights, 32 layers: a ragged int8
               adapter bank (buckets 4, 8, 16; 6 tenants by register_dual),
               12 requests of byte-tokenized log text sharing a 512-token
               prefix per tenant, int8 K/V, prefix caching over a pool
               pinned at about 3/4 of residency: a cold run (prefix hits, preemption), a warm run (the pool
               reused across calls) and a speculative run, with the
               "cuda"/"torch" first-chunk logits, the first suffix chunk
               after a prefix hit against the same positions prefilled
               cold, and the streams held to stated tolerances; one traced
               warm run;
  4b. sharded — the same weights, the serve cell's 8 requests and 8
               tenants' rank-16 fused adapters in a ShardedAdapterRegistry,
               8 slots, "cuda", overlap on: num_shards 1, 2 and 4 (streams
               bitwise equal, adapter placement for all 8), the prefix
               cache cold then warm at 2 shards on a pinned pool (cold
               bitwise the run without the cache, every full block hit on
               its shard, warm against cold by the margin rule), a
               hot-swap at 2 shards after the first decode round
               (untouched streams bitwise those of the run without it),
               int8 K/V over a ragged int8 bank at 1 and 2 shards (bitwise),
               the first chunk "cuda" vs "torch" through the 2-shard
               registry's kernel view; TTFT, decode tok/s and peak memory
               per run, the bank concatenation's ms;
  4c. fixed  — the fixed-batch path: one 64-token prompt, 16 new tokens,
               cache_len 128: generate_fixed over the 8 tenants (batched
               LoRA at 8 rows a step) and the single-tenant Engine with one
               Eq. 7-merged adapter (lora_matmul at 8 rows a step), the
               last prompt position's logits "cuda" vs "torch", the
               streams against the continuous engine's by the margin rule,
               ms per step and tok/s;
  5. train   — FDLoRA Algorithm 1 on the same llama2-7b weights (32 layers,
               full width, bf16), rank-16 adapters on all 7 targets, 2
               clients of 8 x 256-token SFT batches: one train step and one
               fused evaluation through "cuda" and "torch" held to stated
               bounds, then FDLoRATrainer.fit through the kernels (12 train
               steps, 18 fused evaluations), publish into an AdapterRegistry
               and generate from it; FDLoRA's answer accuracy on 32
               held-out examples a client; one traced train step and one
               traced fused evaluation;
  5b. baselines — the same weights and data: Local and the six baselines
               (FedAvg, FedProx, FedAMP, FedRep, FedRoD, FedKD) each fit
               through the kernels at FedConfig(n_clients=2, rounds=2,
               local_steps=1), with s per round, train tokens/s, peak
               memory, bytes communicated, launches by tile and the answer
               accuracy of the returned adapters beside FDLoRA's; one step
               of FedProx, FedRoD (rank 2r) and FedKD (a rank-r/2 student)
               and answer_accuracy through "cuda" and "torch" held to
               stated bounds; one make_fdlora_round_step round (2 clients
               stacked, K 2) with the pseudo-gradient in fp32 and in bf16,
               the bf16 one held to a derived bound; one traced FedRoD
               step;
  6. dense_family — with llama2-7b's weights freed, gemma-2b, olmo-1b,
               yi-6b and starcoder2-15b in turn at their published width
               and depth, bf16, random weights from --seed, 4 tenants with
               rank-16 fused adapters: 4 requests (prompts 128-1024 tokens;
               starcoder2-15b one more of 4,608 tokens, past its window),
               16 new tokens, through "cuda" with overlap on and off
               (streams bitwise equal, every serving kernel launched,
               prefill attention and batched LoRA on their tensor-core
               tiles), the first chunk held to "torch" (bf16 and fp32
               activations); gemma-2b also a train step held to "torch"
               (flash attention at head dim 256), starcoder2-15b the long
               prompt's last chunk, where the window binds, held to
               "torch", and "torch" without the window shown to miss it;
  7. moe     — dbrx-132b (8 of its 40 layers) and kimi-k2-1t-a32b (1 of
               its 61) at their published width, bf16, random weights from
               --seed, 4 tenants with rank-16 fused adapters (the router's
               pair included): 4 requests (prompts 128-1024 tokens), 16 new
               tokens, through "cuda" with overlap on and off (streams
               bitwise equal, every serving kernel launched, prefill
               attention and batched LoRA on their tensor-core tiles), the
               decode step beside the byte bound of reading every expert;
               the first chunk twice through "cuda" (bitwise equal) and
               through "torch" with each layer's expert ids pinned to the
               "cuda" run's (bf16; dbrx-132b also fp32 activations), every
               routing flip held by the router-logit margin, the dropped
               copies per layer equal; one traced dbrx-132b run with the
               expert products and the routing and dispatch as rows of
               their own;
  8. the card's name and power limit, the kernel summary line, and last the
     result line.

batched_dual_lora_matmul, which no path of the port (or of the reference
package) calls, is driven at its own entry point in the kernels phase, at
the serving shapes, and held against its plain version there.

Needs a CUDA device and the repository's src/ beside this file; exits
non-zero otherwise, and on any failed check.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

# published H100 SXM peaks (data sheet, dense), for the bounds
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

ROOT = Path(__file__).resolve().parent
ARCH = "llama2-7b"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class CheckFailed(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back runs (CUDA
    events around the run, after ``warmup`` runs)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# kernels of the four LoRA kernels, by the part of the call they compute
# (their tile's name says which: lora_mma_* and the dual merge the
# tensor-core tile, the others the fp32 tile)
LORA_PARTS = (("lora_mma_dual_zprep_kernel", "z_prep"),
              ("lora_mma_dual_bprep_kernel", "b_prep"),
              ("lora_mma_dual_reduce_kernel", "split_k_reduce"),
              ("dual_lora_merge_kernel", "merge"),
              ("dual_lora_xa_kernel", "shrink"),
              ("dual_lora_xw_kernel", "tile"),
              ("batched_dual_xa_kernel", "shrink"),
              ("batched_dual_xw_kernel", "tile"),
              ("lora_mma_shrink_kernel", "shrink"),
              ("lora_mma_zprep_kernel", "z_prep"),
              ("lora_mma_bprep_kernel", "b_prep"),
              ("lora_mma_reduce_kernel", "split_k_reduce"),
              ("lora_mma_kernel", "tile"),
              ("lora_shrink_kernel", "shrink"),
              ("lora_matmul_kernel", "tile"),
              ("single_lora_xa_kernel", "shrink"),
              ("single_lora_xw_kernel", "tile"))


def device_ms(fn, reps: int, parts=()):
    """The kernel's own device time per call: every CUDA kernel's device
    time in a ``torch.profiler`` trace of ``reps`` back-to-back calls of
    ``fn``, over ``reps`` (the wrapper's host cost, which CUDA events
    around short calls read instead, is left out).  ``parts`` ((name
    substring, part), ...) splits it by kernel.  Returns (ms, {part: ms}).

    A trace now and then comes back with device events missing (seen on
    sub-millisecond windows), which lowers the sum: a trace counts only if
    it holds ``reps`` times the device events of a traced single call, and
    is taken again otherwise (``DEVICE_TRACE_RETAKES`` counts how often)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def trace(n):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        return [ev for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA]

    fn()
    torch.cuda.synchronize()
    for attempt in range(TRACE_ATTEMPTS):
        per_call = sum(ev.count for ev in trace(1))
        evs = trace(reps)
        seen = sum(ev.count for ev in evs)
        if per_call > 0 and seen == reps * per_call:
            break
        DEVICE_TRACE_RETAKES.append({"events": seen, "per_call": per_call,
                                     "reps": reps})
    else:
        require(False, f"{TRACE_ATTEMPTS} profiler traces dropped device "
                       f"events: {DEVICE_TRACE_RETAKES[-TRACE_ATTEMPTS:]}")
    total, split = 0.0, {}
    for ev in evs:
        ms = (getattr(ev, "self_device_time_total", None)
              or getattr(ev, "self_cuda_time_total", 0)) / 1e3 / reps
        total += ms
        part = next((p for k, p in parts if k in ev.key), None)
        if part is not None:
            split[part] = split.get(part, 0.0) + ms
    require(total > 0, "the profiler saw no device time")
    return total, split


# traces of device_ms taken again because they lacked device events, and
# how many tries a measurement gets
DEVICE_TRACE_RETAKES = []
TRACE_ATTEMPTS = 4


def bound(bytes_moved: float, flops: float, fp32: bool = False):
    """(least ms, what sets it): bytes over the memory rate against
    operations over the bf16 tensor-core peak (``fp32``: the fp32 peak
    outside the tensor cores)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (FP32_FLOPS if fp32 else BF16_FLOPS) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def _pools(gen, NB, bs, Kv, hd, device, int8: bool):
    import torch
    from repro_torch.kernels.quant import quantize_int8
    kf = torch.randn((NB, bs, Kv, hd), generator=gen, device=device)
    vf = torch.randn((NB, bs, Kv, hd), generator=gen, device=device)
    if not int8:
        return kf.to(torch.bfloat16), vf.to(torch.bfloat16), None, None
    kq, ks = quantize_int8(kf, dim=-1)
    vq, vs = quantize_int8(vf, dim=-1)
    return kq, vq, ks, vs


def _tables(gen, B, MB, device):
    """Disjoint block tables over blocks 1..B*MB (block 0 is scratch)."""
    import torch
    perm = torch.randperm(B * MB, generator=gen, device=device) + 1
    return perm.reshape(B, MB).to(torch.int32).contiguous()


def _bf16_tol(ref) -> float:
    """Two bf16 roundings of the largest output: both sides compute in
    fp32 from the same inputs and round once, in another summation order."""
    return float(ref.float().abs().max()) * 2.0 ** -7 + 1e-5


def _attn_tol(ref, v) -> float:
    """An attention kernel against its plain version.  bf16: two bf16
    roundings of the largest output, plus one bf16 rounding of the largest
    |v| (dequantized): the tensor-core tile rounds P (or P·v_scale) to bf16
    as its mma operand, as the TPU kernel does, where the plain version
    keeps P in fp32 (or rounds it after normalising); each output is a
    convex sum of v, so that rounding moves it by at most 2^-8·max|v|.
    fp32: the fp32 tile, summation order only, tight."""
    import torch
    top = float(ref.float().abs().max())
    if ref.dtype == torch.float32:
        return 2e-5 + 1e-5 * top
    return _bf16_tol(ref) + float(v.float().abs().max()) * 2.0 ** -8


def _tile_check(what, out, tile_ref):
    """A bf16 output of the tensor-core tile against its tile reference
    (``kernels/attn_tile.py``: the plain arithmetic rounding P where and as
    the tile does): every row within two bf16 ulps of its own largest
    output.  A fault confined to long rows (a dropped or stale key tile)
    moves those rows' small outputs far past that, where ``_attn_tol``,
    set by the largest output of the whole tensor, may not see it.
    Returns {"tile_max_abs_err", "tile_err_ratio"} (ratio <= 1 holds)."""
    from repro_torch.kernels.attn_tile import tile_errors
    err, ratio = tile_errors(out, tile_ref)
    require(ratio <= 1.0, f"{what}: a row is {ratio:.3g}x its bound of two "
            f"bf16 ulps off the tile reference (max abs err {err})")
    return {"tile_max_abs_err": err, "tile_err_ratio": ratio}


def _one_tile(name, fn, dtype):
    """Run ``fn`` once with the counts at 0 and require that kernel
    ``name`` launched the tile its dtype picks: mma for bf16, f32 for
    fp32.  Returns fn's result."""
    import torch
    from repro_torch import kernels
    kernels.reset_launch_counts()
    out = fn()
    tiles = kernels.tile_counts()[name]
    want = ({"mma": 1, "f32": 0} if dtype == torch.bfloat16
            else {"mma": 0, "f32": 1})
    require(tiles == want, f"{name} {dtype}: tiles launched {tiles}, not "
            f"{want}")
    return out


def _gathered(k_pool, v_pool, ks, vs, bt, H):
    """K/V gathered per row and expanded to H heads, (B, H, L, hd) bf16 —
    the library yardstick's input, prepared outside its timing."""
    from repro_torch.kernels.ref import _gather_pool
    Kv = k_pool.shape[2]
    k = _gather_pool(k_pool, ks, bt, H // Kv)
    v = _gather_pool(v_pool, vs, bt, H // Kv)
    return (k.permute(0, 2, 1, 3).contiguous(),
            v.permute(0, 2, 1, 3).contiguous())


# the decode kernel's two kernels, by the part of the call they compute
DECODE_PARTS = (("paged_decode_split_kernel", "split"),
                ("paged_decode_combine_kernel", "combine"))


def check_decode(gen, device, lengths, G, int8, reps, H=32, hd=128, bs=16,
                 window=0):
    """The split-K decode kernel against its plain version (bf16 q: two
    bf16 roundings of the largest output); its time (events and device),
    its device time by part (split, combine) and SPLIT with the live
    splits of each row (with a ``window``, whole splits below it drop
    out); SDPA over K/V gathered outside its timing, by events and by
    device time, as the library yardstick."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.kernels.paged_attention import (SPLIT, paged_attention,
                                                     paged_attention_ref)
    B = len(lengths)
    Kv = H // G
    MB = -(-max(lengths) // bs)
    kp, vp, ks, vs = _pools(gen, 1 + B * MB, bs, Kv, hd, device, int8)
    bt = _tables(gen, B, MB, device)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    q = torch.randn((B, H, hd), generator=gen, device=device).to(torch.bfloat16)

    def call():
        return paged_attention(q, kp, vp, bt, lens, k_scale=ks, v_scale=vs,
                               sliding_window=window)

    kernels.reset_launch_counts()
    out = call()
    f = paged_attention
    launched = {"calls": f.launches, "splits_per_row": f.launches_split,
                "combine": f.launches_combine}
    ref = paged_attention_ref(q, kp, vp, bt, lens, k_scale=ks, v_scale=vs,
                              sliding_window=window)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    tol = _bf16_tol(ref)
    what = f"paged_attention G={G} hd={hd} int8={int8} window={window}"
    require(bool(torch.isfinite(out.float()).all()), f"{what}: not finite")
    require(err <= tol, f"{what}: err {err} > {tol}")
    zero_rows = [i for i, n in enumerate(lengths) if n == 0]
    require(all(float(out[i].float().abs().max()) == 0.0 for i in zero_rows),
            f"{what}: an empty decode row is not zero")
    # each row's live splits, worked out from its length and the window
    # (not measured)
    row_splits = [-(-n // SPLIT) - (max(0, n - window) // SPLIT if window
                                    else 0) for n in lengths]
    want = {"calls": 1, "splits_per_row": -(-MB * bs // SPLIT),
            "combine": int(MB * bs > SPLIT)}
    require(launched == want, f"{what}: launched {launched}, not {want}")
    ms = time_ms(call, reps)
    dev_ms, parts = device_ms(call, reps, DECODE_PARTS)
    require(set(parts) == ({"split", "combine"} if want["combine"]
                           else {"split"}),
            f"{what}: device parts {sorted(parts)}")
    plain_ms = time_ms(lambda: paged_attention_ref(
        q, kp, vp, bt, lens, k_scale=ks, v_scale=vs, sliding_window=window),
        max(1, reps // 4), 1)
    kg, vg = _gathered(kp, vp, ks, vs, bt, H)
    kg, vg = kg.to(torch.bfloat16), vg.to(torch.bfloat16)
    L = kg.shape[2]
    k_pos = torch.arange(L, device=device)[None, :]
    mask = k_pos < lens[:, None]
    if window:
        mask &= k_pos >= lens[:, None] - window
    mask = mask[:, None, None, :]
    q4 = q[:, :, None, :]

    def library():
        return F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask)

    library_ms = time_ms(library, reps)
    library_device_ms, _ = device_ms(library, reps)
    # positions attended: the window's worth of each row
    ctx = int(sum(min(n, window) if window else n for n in lengths))
    kv_bytes = (1 if int8 else 2) * 2 * ctx * Kv * hd + (8 * ctx * Kv if int8
                                                          else 0)
    nbytes = kv_bytes + 2 * 2 * B * H * hd + 4 * B * (MB + 1)
    flops = 4 * hd * H * ctx
    b_ms, b_by = bound(nbytes, flops)
    return {"name": "paged_attention", "G": G, "kv": "int8" if int8 else "bf16",
            "B": B, "H": H, "hd": hd, "bs": bs, "window": window,
            "lengths": lengths,
            "split_len": SPLIT, "row_splits_from_lengths": row_splits,
            "launched": launched,
            "max_abs_err": err, "tol": tol, "ms": ms, "device_ms": dev_ms,
            "device_ms_by_part": parts, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_device_ms": library_device_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def check_prefill(gen, device, lengths, T, G, int8, reps, H=32, hd=128,
                  bs=16, dtype=None, window=0):
    """Tolerance: ``_attn_tol`` against the plain version (bf16 queries:
    the tensor-core tile, also held per row to its tile reference by
    ``_tile_check``; fp32: the fp32 tile, tight).  SDPA over K/V gathered
    outside its timing, by events and by device time, is the library
    yardstick."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.attn_tile import paged_prefill_tile_ref
    from repro_torch.kernels.paged_prefill import (paged_prefill_attention,
                                                   paged_prefill_attention_ref)
    dtype = dtype or torch.bfloat16
    B = len(lengths)
    Kv = H // G
    MB = -(-(max(lengths) + T) // bs)
    kp, vp, ks, vs = _pools(gen, 1 + B * MB, bs, Kv, hd, device, int8)
    bt = _tables(gen, B, MB, device)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    q = torch.randn((B, T, H, hd), generator=gen, device=device).to(dtype)
    kw = {"k_scale": ks, "v_scale": vs, "sliding_window": window}

    def call():
        return paged_prefill_attention(q, kp, vp, bt, lens, **kw)

    what = f"paged_prefill G={G} hd={hd} int8={int8} window={window}"
    out = _one_tile("paged_prefill_attention", call, dtype)
    ref = paged_prefill_attention_ref(q, kp, vp, bt, lens, **kw)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    tol = _attn_tol(ref, vp.float() * vs[..., None] if int8 else vp)
    require(bool(torch.isfinite(out.float()).all()),
            f"{what}: output not finite")
    require(err <= tol, f"{what} {dtype}: err {err} > {tol}")
    tile = {}
    if dtype == torch.bfloat16:
        tile = _tile_check(what, out, paged_prefill_tile_ref(
            q, kp, vp, bt, lens, **kw))
    ms = time_ms(call, reps)
    dev_ms, _ = device_ms(call, reps)
    plain_ms = time_ms(lambda: paged_prefill_attention_ref(
        q, kp, vp, bt, lens, **kw), max(1, reps // 4), 1)
    kg, vg = _gathered(kp, vp, ks, vs, bt, H)
    kg, vg = kg.to(dtype), vg.to(dtype)
    L = kg.shape[2]
    q_pos = lens[:, None] + torch.arange(T, device=device)[None, :]
    k_pos = torch.arange(L, device=device)[None, None, :]
    mask = k_pos <= q_pos[:, :, None]
    if window:
        mask &= k_pos > q_pos[:, :, None] - window
    mask = mask[:, None]
    qt = q.permute(0, 2, 1, 3).contiguous()

    def library():
        return F.scaled_dot_product_attention(qt, kg, vg, attn_mask=mask)

    library_ms = time_ms(library, reps)
    library_device_ms, _ = device_ms(library, reps)
    W = window or 1 << 30
    # positions read per row (from the first query's window start), and
    # (query, key) pairs attended
    ctx = sum(n + T - max(0, n - W + 1) for n in lengths)
    pairs = sum(min(n + t + 1, W) for n in lengths for t in range(T))
    kv_bytes = (1 if int8 else 2) * 2 * ctx * Kv * hd + (8 * ctx * Kv if int8
                                                          else 0)
    q_el = q.element_size()
    nbytes = kv_bytes + 2 * q_el * B * T * H * hd + 4 * B * (MB + 1)
    flops = 4 * hd * H * pairs
    b_ms, b_by = bound(nbytes, flops, fp32=dtype == torch.float32)
    return {"name": "paged_prefill_attention", "G": G,
            "kv": "int8" if int8 else "bf16",
            "q": "bf16" if dtype == torch.bfloat16 else "fp32",
            "tile": "mma" if dtype == torch.bfloat16 else "f32",
            "B": B, "T": T, "H": H,
            "hd": hd, "bs": bs, "window": window, "lengths": lengths,
            "max_abs_err": err, "tol": tol, **tile, "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_device_ms": library_device_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def _lora_tol(ref) -> float:
    """A LoRA kernel against its plain version: bf16, two bf16 roundings
    of the largest output (both compute in fp32 and round once, in another
    order); fp32 (the fp32 tile), 1e-4 + 1e-4·max|out|, the card tests'
    tolerance."""
    import torch
    if ref.dtype == torch.float32:
        return 1e-4 + 1e-4 * float(ref.abs().max())
    return _bf16_tol(ref)


def _lora_share(parts, dead_parts, total):
    """The shrink's and the epilogue's device ms and share of a call: the
    shrink, the LoRA operands' preparation, any split-K reduction, and the
    tile's time beyond the same tile with no live row (which then runs no
    LoRA stage): the expand z·B, the epilogue of the LoRA product."""
    epi = parts["tile"] - dead_parts["tile"]
    lora = epi + sum(parts.get(k, 0.0) for k in ("shrink", "z_prep", "b_prep",
                                                  "split_k_reduce"))
    return {"tile_without_lora_ms": dead_parts["tile"], "epilogue_ms": epi,
            "shrink_and_epilogue_ms": lora,
            "shrink_and_epilogue_share": lora / total}


def check_lora(gen, device, M, K, N, C, r, variant, reps, dtype=None,
               by_request=False, share=False):
    """batched_lora_matmul against its plain version (``_lora_tol``): bf16
    activations run the tensor-core tile, fp32 ones (over the same bf16 W)
    the fp32 tile.  Every row draws its own client, so every tile mixes
    clients, unless ``by_request``: rows in runs of 256 per client, as a
    prefill dispatch lays them out.  ``share``: also the shrink's and the
    epilogue's share of the call's device time (``_lora_share``)."""
    import torch
    from repro_torch.kernels.batched_lora import (batched_lora_matmul,
                                                  batched_lora_matmul_ref)
    from repro_torch.kernels.quant import quantize_int8
    dtype = dtype or torch.bfloat16
    x = torch.randn((M, K), generator=gen, device=device).to(dtype)
    w = (torch.randn((K, N), generator=gen, device=device)
         * K ** -0.5).to(torch.bfloat16)
    a = torch.randn((C, K, r), generator=gen, device=device) / r
    b = torch.randn((C, r, N), generator=gen, device=device) * 0.02
    if by_request:
        ids = torch.randint(0, C, (-(-M // 256),), generator=gen,
                            device=device, dtype=torch.int32)
        ids = torch.repeat_interleave(ids, 256)[:M].contiguous()
    else:
        ids = torch.randint(0, C, (M,), generator=gen, device=device,
                            dtype=torch.int32)
    kw = {}
    if variant == "rank_mask":
        kw["ranks"] = torch.randint(1, r + 1, (C,), generator=gen,
                                    device=device, dtype=torch.int32)
    if variant == "int8_bank":
        a, sa = quantize_int8(a, dim=(1, 2))
        b, sb = quantize_int8(b, dim=(1, 2))
        kw.update(a_scale=sa.contiguous(), b_scale=sb.contiguous())
    scale = 2.0

    def call():
        return batched_lora_matmul(x, w, a, b, ids, scale, **kw)
    out = _one_tile("batched_lora_matmul", call, dtype)
    ref = batched_lora_matmul_ref(x, w, a, b, ids, scale, **kw)
    tol = _lora_tol(ref)
    err = _check_close(f"batched_lora {variant} M={M} {dtype}", out, ref, tol)
    ms = time_ms(call, reps)
    dev_ms, parts = device_ms(call, reps, LORA_PARTS)
    extra = {}
    if share:
        dead = torch.full_like(ids, -1)
        _, dead_parts = device_ms(lambda: batched_lora_matmul(
            x, w, a, b, dead, scale, **kw), reps, LORA_PARTS)
        extra = _lora_share(parts, dead_parts, dev_ms)
    plain_ms = time_ms(lambda: batched_lora_matmul_ref(
        x, w, a, b, ids, scale, **kw), max(1, reps // 4), 1)
    library_ms = time_ms(lambda: torch.matmul(x, w.to(dtype)), reps)
    active = int(torch.unique(ids).numel())
    bank_el = 1 if variant == "int8_bank" else 4
    x_el = x.element_size()
    nbytes = (x_el * M * K + 2 * K * N + x_el * M * N + 4 * M
              + active * bank_el * r * (K + N))
    flops = 2 * M * K * N + 2 * M * r * (K + N)
    b_ms, b_by = bound(nbytes, flops, fp32=dtype == torch.float32)
    return {"name": "batched_lora_matmul", "variant": variant,
            "activations": "bf16" if dtype == torch.bfloat16 else "fp32",
            "tile": "mma" if dtype == torch.bfloat16 else "f32",
            "ids": "by_request" if by_request else "per_row", "M": M,
            "K": K, "N": N, "C": C, "r": r, "max_abs_err": err, "tol": tol,
            "ms": ms, "device_ms": dev_ms, "device_ms_by_part": parts,
            **extra, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def dual_inputs(gen, device, M, K, N, C, r):
    """Serving-shape inputs of batched_dual_lora_matmul: bf16 x and W, an
    fp32 personalized bank and global pair, per-row clients and fusion
    weights drawn in [-0.2, 1.2] (the reference test's range)."""
    import torch
    x = torch.randn((M, K), generator=gen, device=device).to(torch.bfloat16)
    w = (torch.randn((K, N), generator=gen, device=device)
         * K ** -0.5).to(torch.bfloat16)
    a1 = torch.randn((C, K, r), generator=gen, device=device) / r
    b1 = torch.randn((C, r, N), generator=gen, device=device) * 0.02
    a2 = torch.randn((K, r), generator=gen, device=device) / r
    b2 = torch.randn((r, N), generator=gen, device=device) * 0.02
    ids = torch.randint(0, C, (M,), generator=gen, device=device,
                        dtype=torch.int32)
    fw = torch.rand((M, 2), generator=gen, device=device) * 1.4 - 0.2
    return x, w, a1, b1, a2, b2, ids, fw


def check_dual_batched(inputs, out, reps):
    """batched_dual_lora_matmul's output ``out`` (from the entry-point run,
    bf16: the tensor-core tile) against its plain version, each row against
    the tile model (``_tile_check``), and rows sharing one (w1, w2) against
    batched_lora_matmul on the pre-merged bank; both to two bf16 roundings
    of the largest output."""
    import torch
    from repro_torch.kernels.batched_lora import (
        batched_dual_lora_matmul, batched_dual_lora_matmul_ref,
        batched_lora_matmul)
    from repro_torch.kernels.lora_tile import dual_split_plan_ref
    x, w, a1, b1, a2, b2, ids, fw = inputs
    M, K = x.shape
    N, (C, _, r) = w.shape[1], a1.shape
    scale = 2.0
    ref = batched_dual_lora_matmul_ref(x, w, a1, b1, a2, b2, ids, fw, scale)
    tol = _bf16_tol(ref)
    err = _check_close("batched_dual_lora_matmul", out, ref, tol)
    tile = _tile_check(f"batched_dual_lora_matmul M={M}", out,
                       dual_split_plan_ref(x, w, a1, b1, a2, b2, ids, fw,
                                           scale))
    # one shared (w1, w2): the Eq. 7 pre-merged bank through the plain
    # batched kernel
    w1, w2 = 0.7, 0.4
    fw1 = torch.tensor([[w1, w2]], device=x.device).expand(M, 2).contiguous()
    merged = batched_lora_matmul(x, w, (w1 * a1 + w2 * a2).contiguous(),
                                 (w1 * b1 + w2 * b2).contiguous(), ids, scale)
    shared_err = _check_close(
        "batched_dual_lora_matmul vs pre-merged batched_lora_matmul",
        batched_dual_lora_matmul(x, w, a1, b1, a2, b2, ids, fw1, scale),
        merged, _bf16_tol(merged))

    def call():
        return batched_dual_lora_matmul(x, w, a1, b1, a2, b2, ids, fw, scale)
    ms = time_ms(call, reps)
    dev_ms, parts = device_ms(call, reps, LORA_PARTS)
    plain_ms = time_ms(lambda: batched_dual_lora_matmul_ref(
        x, w, a1, b1, a2, b2, ids, fw, scale), max(1, reps // 4), 1)
    library_ms = time_ms(lambda: torch.matmul(x, w), reps)
    active = int(torch.unique(ids).numel())
    # x, W, the active clients' A1/B1 and the global pair read once, ids and
    # weights, y written
    nbytes = (2 * M * K + 2 * K * N + 4 * (active + 1) * r * (K + N)
              + 12 * M + 2 * M * N)
    # the base product plus both pairs' shrink and expand per row
    flops = 2 * M * K * N + 4 * M * r * (K + N)
    b_ms, b_by = bound(nbytes, flops)
    return {"name": "batched_dual_lora_matmul", "activations": "bf16",
            "tile": "mma", "M": M, "K": K, "N": N, "C": C, "r": r,
            "max_abs_err": err, "tol": tol, **tile,
            "shared_weights_vs_merged_err": shared_err, "ms": ms,
            "device_ms": dev_ms, "device_ms_by_part": parts,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def check_dual_batched_fp32(inputs, reps):
    """batched_dual_lora_matmul with fp32 activations over the same bf16
    W: the fp32 tile, held at 1e-4 + 1e-4·max|out| (``_lora_tol``)."""
    import torch
    from repro_torch.kernels.batched_lora import (
        batched_dual_lora_matmul, batched_dual_lora_matmul_ref)
    x, w, a1, b1, a2, b2, ids, fw = inputs
    x = x.float()
    M, K = x.shape
    N, r = w.shape[1], a1.shape[2]

    def call():
        return batched_dual_lora_matmul(x, w, a1, b1, a2, b2, ids, fw, 2.0)
    out = _one_tile("batched_dual_lora_matmul", call, torch.float32)
    ref = batched_dual_lora_matmul_ref(x, w, a1, b1, a2, b2, ids, fw, 2.0)
    tol = _lora_tol(ref)
    err = _check_close("batched_dual_lora_matmul fp32", out, ref, tol)
    ms = time_ms(call, reps)
    dev_ms, parts = device_ms(call, reps, LORA_PARTS)
    active = int(torch.unique(ids).numel())
    nbytes = (4 * M * K + 2 * K * N + 4 * (active + 1) * r * (K + N)
              + 12 * M + 4 * M * N)
    b_ms, b_by = bound(nbytes, 2 * M * K * N + 4 * M * r * (K + N),
                       fp32=True)
    return {"name": "batched_dual_lora_matmul", "activations": "fp32",
            "tile": "f32", "M": M, "K": K, "N": N, "r": r,
            "max_abs_err": err, "tol": tol, "ms": ms, "device_ms": dev_ms,
            "device_ms_by_part": parts, "bound_ms": b_ms, "bound_by": b_by}


def dual_entry_point(device, seed: int, reps: int, B: int, T: int):
    """batched_dual_lora_matmul at its own entry point (no path calls it):
    one call at the decode shape (B x 4096 x 4096) and one at the prefill
    shape (B*T x 4096 x 11008), C = 8, r = 16, with the launch counts set to
    0 just before and read just after; then each output is checked and the
    kernel timed.  Returns (prefill-shape result, launches)."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.batched_lora import batched_dual_lora_matmul
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    shapes = ((B, 4096, 4096), (B * T, 4096, 11008))
    inputs = [dual_inputs(gen, device, M, K, N, 8, 16) for M, K, N in shapes]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    outs = [batched_dual_lora_matmul(*inp, 2.0) for inp in inputs]
    torch.cuda.synchronize()
    launches = kernels.launch_counts()["batched_dual_lora_matmul"]
    require(launches == len(shapes),
            f"batched_dual_lora_matmul launched {launches} times, not "
            f"{len(shapes)}")
    require_mma_tile(kernels.tile_counts(), "batched_dual_lora_matmul",
                     "the batched dual-LoRA entry point")
    results = [check_dual_batched(inp, out, reps)
               for inp, out in zip(inputs, outs)]
    for res in results:
        emit(res)
    emit(check_dual_batched_fp32(inputs[-1], reps))
    return results[-1], launches


def _lora_inputs(gen, device, M, K, N, r):
    import torch
    x = torch.randn((M, K), generator=gen, device=device).to(torch.bfloat16)
    w = (torch.randn((K, N), generator=gen, device=device)
         * K ** -0.5).to(torch.bfloat16)
    a = torch.randn((K, r), generator=gen, device=device) / r
    b = torch.randn((r, N), generator=gen, device=device) * 0.02
    return x, w, a, b


def _check_close(name, out, ref, tol):
    import torch
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    require(bool(torch.isfinite(out.float()).all()), f"{name} output not finite")
    require(err <= tol, f"{name}: err {err} > {tol}")
    return err


def check_single_lora(gen, device, M, K, N, r, reps, dtype=None,
                      share=False):
    """lora_matmul at a training projection's shape, against its plain
    version (``_lora_tol``): bf16 activations run the tensor-core tile,
    fp32 ones (over the same bf16 W) the fp32 tile.  ``share``: the
    shrink's and the epilogue's share of the call's device time, the
    epilogue timed through batched_lora_matmul with one client, which runs
    the same tile code (ids 0 against ids -1)."""
    import torch
    from repro_torch.kernels.batched_lora import batched_lora_matmul
    from repro_torch.kernels.lora_matmul import lora_matmul, lora_matmul_ref
    dtype = dtype or torch.bfloat16
    x, w, a, b = _lora_inputs(gen, device, M, K, N, r)
    x = x.to(dtype)
    scale = 2.0
    ref = lora_matmul_ref(x, w, a, b, scale)
    tol = _lora_tol(ref)
    out = _one_tile("lora_matmul", lambda: lora_matmul(x, w, a, b, scale),
                    dtype)
    err = _check_close(f"lora_matmul {dtype}", out, ref, tol)
    ms = time_ms(lambda: lora_matmul(x, w, a, b, scale), reps)
    dev_ms, parts = device_ms(lambda: lora_matmul(x, w, a, b, scale), reps,
                              LORA_PARTS)
    extra = {}
    if share:
        one = torch.zeros((M,), dtype=torch.int32, device=device)
        _, live = device_ms(lambda: batched_lora_matmul(
            x, w, a[None], b[None], one, scale), reps, LORA_PARTS)
        _, dead = device_ms(lambda: batched_lora_matmul(
            x, w, a[None], b[None], one - 1, scale), reps, LORA_PARTS)
        extra = _lora_share(parts, {"tile": parts["tile"] - live["tile"]
                                    + dead["tile"]}, dev_ms)
    plain_ms = time_ms(lambda: lora_matmul_ref(x, w, a, b, scale),
                       max(1, reps // 4), 1)
    ab, bb, wd = a.to(x.dtype), b.to(x.dtype), w.to(x.dtype)
    library_ms = time_ms(lambda: torch.matmul(x, wd) + (x @ ab) @ bb, reps)
    # x, W in; A, B fp32 in; y out and z = x·A out (fp32)
    x_el = x.element_size()
    nbytes = (x_el * M * K + 2 * K * N + 4 * r * (K + N) + x_el * M * N
              + 4 * M * r)
    flops = 2 * M * K * N + 2 * M * r * (K + N)
    b_ms, b_by = bound(nbytes, flops, fp32=dtype == torch.float32)
    return {"name": "lora_matmul",
            "activations": "bf16" if dtype == torch.bfloat16 else "fp32",
            "tile": "mma" if dtype == torch.bfloat16 else "f32",
            "M": M, "K": K, "N": N, "r": r,
            "max_abs_err": err, "tol": tol, "ms": ms, "device_ms": dev_ms,
            "device_ms_by_part": parts, **extra, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by}


def check_dual_lora(gen, device, M, K, N, r, reps, dtype=None):
    """dual_lora_matmul at a fused evaluation's shape, fusion weights
    (0.6, 0.6), against its plain version (``_lora_tol``): bf16
    activations run the tensor-core tile and each row is also held to the
    tile model (``_tile_check``), fp32 ones (over the same bf16 W) the fp32
    tile."""
    import torch
    from repro_torch.kernels.dual_lora import (dual_lora_matmul,
                                               dual_lora_matmul_ref)
    from repro_torch.kernels.lora_tile import dual_split_plan_ref
    dtype = dtype or torch.bfloat16
    x, w, a1, b1 = _lora_inputs(gen, device, M, K, N, r)
    x = x.to(dtype)
    a2 = torch.randn((K, r), generator=gen, device=device) / r
    b2 = torch.randn((r, N), generator=gen, device=device) * 0.02
    fw = torch.tensor([0.6, 0.6], device=device)
    scale = 2.0

    def call():
        return dual_lora_matmul(x, w, a1, b1, a2, b2, fw, scale)
    ref = dual_lora_matmul_ref(x, w, a1, b1, a2, b2, fw[0], fw[1], scale)
    tol = _lora_tol(ref)
    out = _one_tile("dual_lora_matmul", call, dtype)
    err = _check_close(f"dual_lora_matmul {dtype}", out, ref, tol)
    tile = {}
    if dtype == torch.bfloat16:
        tile = _tile_check(f"dual_lora_matmul {M}x{K}x{N}", out,
                           dual_split_plan_ref(x, w, a1, b1, a2, b2, None,
                                               fw, scale))
    ms = time_ms(call, reps)
    dev_ms, parts = device_ms(call, reps, LORA_PARTS)
    plain_ms = time_ms(lambda: dual_lora_matmul_ref(
        x, w, a1, b1, a2, b2, fw[0], fw[1], scale), max(1, reps // 4), 1)
    am = (0.6 * a1 + 0.6 * a2).to(x.dtype)     # merged outside the timing
    bm = (0.6 * b1 + 0.6 * b2).to(x.dtype)
    wd = w.to(x.dtype)
    library_ms = time_ms(lambda: torch.matmul(x, wd) + (x @ am) @ bm, reps)
    x_el = x.element_size()
    nbytes = (x_el * M * K + 2 * K * N + 8 * r * (K + N) + 8
              + x_el * M * N)
    flops = 2 * M * K * N + 2 * M * r * (K + N) + 3 * r * (K + N)
    b_ms, b_by = bound(nbytes, flops, fp32=dtype == torch.float32)
    return {"name": "dual_lora_matmul",
            "activations": "bf16" if dtype == torch.bfloat16 else "fp32",
            "tile": "mma" if dtype == torch.bfloat16 else "f32",
            "M": M, "K": K, "N": N, "r": r,
            "max_abs_err": err, "tol": tol, **tile, "ms": ms,
            "device_ms": dev_ms, "device_ms_by_part": parts,
            "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by}


def check_flash(gen, device, B, H, Kv, Sq, Sk, d, window, reps, dtype=None):
    """flash_attention on model-layout (B, S, heads, d) tensors read through
    strided views, as the training forward calls it.  Tolerance:
    ``_attn_tol`` against the plain version (bf16: the tensor-core tile
    and the plain version each round the probabilities to bf16, at other
    points, and ``_tile_check`` holds each row to the tile reference;
    fp32: tight)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.attn_tile import flash_attention_tile_ref
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    dtype = dtype or torch.bfloat16
    q = torch.randn((B, Sq, H, d), generator=gen, device=device).to(
        dtype).transpose(1, 2)
    k, v = (torch.randn((B, Sk, Kv, d), generator=gen, device=device).to(
        dtype).transpose(1, 2) for _ in range(2))
    ref = flash_attention_ref(q, k, v, sliding_window=window)
    tol = _attn_tol(ref, v)
    out = _one_tile("flash_attention", lambda: flash_attention(
        q, k, v, sliding_window=window), dtype)
    err = _check_close(f"flash_attention {dtype}", out, ref, tol)
    tile = {}
    if dtype == torch.bfloat16:
        tile = _tile_check(f"flash_attention window={window} Sq={Sq} "
                           f"Kv={Kv}", out, flash_attention_tile_ref(
                               q, k, v, sliding_window=window))
    ms = time_ms(lambda: flash_attention(q, k, v, sliding_window=window), reps)
    dev_ms, _ = device_ms(lambda: flash_attention(q, k, v,
                                                  sliding_window=window),
                          reps)
    plain_ms = time_ms(lambda: flash_attention_ref(
        q, k, v, sliding_window=window), max(1, reps // 4), 1)
    # yardstick: SDPA on contiguous (B, H, S, d) with kv heads repeated and
    # the end-aligned mask built outside the timing
    qc = q.contiguous()
    kc, vc = (torch.repeat_interleave(t, H // Kv, dim=1).contiguous()
              for t in (k, v))
    q_pos = torch.arange(Sq, device=device) + (Sk - Sq)
    k_pos = torch.arange(Sk, device=device)
    mask = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    if Sq == Sk and window == 0:
        def library():
            return F.scaled_dot_product_attention(qc, kc, vc, is_causal=True)
    else:
        def library():
            return F.scaled_dot_product_attention(qc, kc, vc, attn_mask=mask)
    library_ms = time_ms(library, reps)
    library_device_ms, _ = device_ms(library, reps)
    pairs = int(mask.sum())
    nbytes = q.element_size() * (2 * B * H * Sq * d + 2 * B * Kv * Sk * d)
    flops = 4 * d * pairs * B * H
    b_ms, b_by = bound(nbytes, flops, fp32=dtype == torch.float32)
    return {"name": "flash_attention",
            "dtype": "bf16" if dtype == torch.bfloat16 else "fp32",
            "tile": "mma" if dtype == torch.bfloat16 else "f32",
            "B": B, "H": H, "Kv": Kv, "Sq": Sq,
            "Sk": Sk, "d": d, "window": window, "max_abs_err": err,
            "tol": tol, **tile, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_device_ms": library_device_ms, "bound_ms": b_ms,
            "bound_by": b_by}


def check_backwards(gen, device):
    """The two autograd functions against plain autograd through the plain
    versions, fp32, on a small shape: the forwards differ in summation order
    only and the backwards are plain PyTorch, so gradients agree to 1e-4."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.lora_matmul import lora_matmul, lora_matmul_ref
    out = {"phase": "backward", "tol": 1e-4}
    M, K, N, r = 256, 512, 384, 16
    w = torch.randn((K, N), generator=gen, device=device) * K ** -0.5
    leaves = [torch.randn(s, generator=gen, device=device) * sd
              for s, sd in (((M, K), 1.0), ((K, r), 1.0 / r), ((r, N), 0.02))]
    dy = torch.randn((M, N), generator=gen, device=device)
    qkv = [torch.randn((2, h, 128, 64), generator=gen, device=device)
           for h in (8, 2, 2)]
    do = torch.randn((2, 8, 128, 64), generator=gen, device=device)
    for name, fns, inputs, g_out in (
            ("lora_matmul", (lambda x, a, b: lora_matmul(x, w, a, b, 2.0),
                             lambda x, a, b: lora_matmul_ref(x, w, a, b, 2.0)),
             leaves, dy),
            ("flash_attention", (
                lambda q, k, v: flash_attention(q, k, v, sliding_window=40),
                lambda q, k, v: flash_attention_ref(q, k, v,
                                                    sliding_window=40)),
             qkv, do)):
        grads = []
        for fn in fns:
            ts = [t.clone().requires_grad_(True) for t in inputs]
            grads.append(torch.autograd.grad(fn(*ts), ts, g_out))
        err = max(float((g - gr).abs().max() / gr.abs().max().clamp(min=1e-30))
                  for g, gr in zip(*grads))
        out[f"{name}_max_rel_grad_err"] = err
        require(err <= 1e-4, f"{name} backward: rel err {err} > 1e-4")
    emit(out)


def training_kernels(device, seed: int, reps: int, registers=None):
    """The training path's kernels, and ``lora_matmul`` at the fixed
    path's decode rows (``registers``: ptxas's count per kernel of
    lora_matmul.cu); returns {name: main-shape result}."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    main = {}
    for K, N in ((4096, 11008), (4096, 4096)):
        res = check_single_lora(gen, device, 2048, K, N, 16, reps,
                                share=(K, N) == (4096, 11008))
        emit(res)
        main.setdefault("lora_matmul", res)
        res = check_dual_lora(gen, device, 2048, K, N, 16, reps)
        emit(res)
        main.setdefault("dual_lora_matmul", res)
    for H, Kv, Sq, Sk, window in ((32, 32, 256, 256, 0), (32, 32, 256, 256, 64),
                                  (32, 32, 128, 256, 0), (32, 8, 256, 256, 0)):
        res = check_flash(gen, device, 8, H, Kv, Sq, Sk, 128, window, reps)
        emit(res)
        main.setdefault("flash_attention", res)
    # gemma-2b's shape: head dim 256, 8 query heads over one kv head
    emit(check_flash(gen, device, 8, 8, 1, 256, 256, 256, 0, reps))
    # gemma-2b's train step (phase dense_family): a 2048-row batch through
    # each of its projections
    for K, N in projection_shapes("gemma-2b"):
        emit({**check_single_lora(gen, device, 2048, K, N, 16, reps),
              "arch": "gemma-2b"})
    # the baselines' ranks (phase baselines): FedKD's student at r/2 = 8 (a
    # partial 16-wide rank group of the tensor-core tile), FedRoD's
    # concatenated pair at 2r = 32 (two groups)
    for r in (8, 32):
        emit({**check_single_lora(gen, device, 2048, 4096, 11008, r, reps),
              "path": "baselines"})
    # the single-tenant engine's decode rows (phase fixed): 8 rows through
    # llama2-7b's projections, the tile's split-K plan
    for K, N in ((4096, 4096), (4096, 11008), (11008, 4096)):
        emit({**check_single_lora(gen, device, 8, K, N, 16, reps),
              "path": "fixed", "registers": registers})
    # fp32 at the main shape: the fp32 tile, held tight
    emit(check_flash(gen, device, 8, 32, 32, 256, 256, 128, 0, reps,
                     dtype=torch.float32))
    check_backwards(gen, device)
    # fp32 activations through lora_matmul and dual_lora_matmul: the fp32
    # tile, held tight
    emit(check_single_lora(gen, device, 2048, 4096, 11008, 16, reps,
                           dtype=torch.float32))
    emit(check_dual_lora(gen, device, 2048, 4096, 11008, 16, reps,
                         dtype=torch.float32))
    return main


def kernel_phase(device, seed: int, reps: int, main_lengths, T: int):
    """Every kernel in every variant; returns {name: main-shape result}."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    main = {}
    # decode rows as in the serving run (context + the step), one empty row
    dec_lengths = [0] + [n + 1 for n in main_lengths[1:]]
    for G in (1, 4):
        for int8 in (False, True):
            res = check_decode(gen, device, dec_lengths, G, int8, reps)
            emit(res)
            if G == 1 and not int8:
                main["paged_attention"] = res
    # the main decode shape must have run several splits of a row: the
    # combine kernel launched (its counter) and took device time (its trace)
    dec = main["paged_attention"]
    require(dec["launched"]["combine"] == 1
            and dec["device_ms_by_part"].get("combine", 0.0) > 0,
            f"the main decode shape ran one split per row: launched "
            f"{dec['launched']}, device parts {dec['device_ms_by_part']}")
    # gemma-2b's decode shape (G 8, head dim 256) and starcoder2-15b's
    # (G 12, head dim 128), at the same lengths
    emit(check_decode(gen, device, dec_lengths, 8, False, reps, H=8, hd=256))
    emit(check_decode(gen, device, dec_lengths, 12, False, reps, H=48))
    # yi-6b's (G 8, head dim 128)
    emit(check_decode(gen, device, dec_lengths, 8, False, reps, H=32))
    # prefill: a chunk of T behind ragged earlier context, one fresh row
    pre_lengths = [0] + [min(n, 768) for n in main_lengths[1:]]
    for G in (1, 4):
        for int8 in (False, True):
            res = check_prefill(gen, device, pre_lengths, T, G, int8, reps)
            emit(res)
            if G == 1 and not int8:
                main["paged_prefill_attention"] = res
    # fp32 queries (the fp32 tile, held tight) over both pool types
    for int8 in (False, True):
        emit(check_prefill(gen, device, pre_lengths, T, 1, int8, reps,
                           dtype=torch.float32))
    # gemma-2b's prefill shape: head dim 256, G 8 over one kv head; yi-6b's
    # (G 8, head dim 128)
    for int8 in (False, True):
        emit(check_prefill(gen, device, pre_lengths, T, 8, int8, reps, H=8,
                           hd=256))
    emit(check_prefill(gen, device, pre_lengths, T, 8, False, reps, H=32))
    # starcoder2-15b's shapes (G 12, hd 128) under its 4096-token window,
    # contexts to 6144: the window binds in the long rows, and whole
    # decode splits below it drop out
    win_dec = [0, 1000, 2048, 4095, 4097, 4500, 5000, 6144]
    res = check_decode(gen, device, win_dec, 12, False, reps, H=48,
                       window=4096)
    require(res["launched"]["combine"] == 1,
            "the windowed decode shape ran one split per row")
    emit(res)
    win_pre = [0, 1000, 3900, 4200, 5000, 6144 - T]
    emit(check_prefill(gen, device, win_pre, T, 12, False, reps, H=48,
                       window=4096))
    B = len(main_lengths)
    for M, K, N in ((B, 4096, 4096), (B * T, 4096, 11008)):
        for variant in ("f32_bank", "rank_mask", "int8_bank"):
            main_row = M == B * T and variant == "f32_bank"
            res = check_lora(gen, device, M, K, N, 8, 16, variant, reps,
                             share=main_row)
            emit(res)
            if main_row:
                main["batched_lora_matmul"] = res
    # the prefill shape with rows in runs of one client per request, as a
    # dispatch lays them out; fp32 activations (the fp32 tile, held tight)
    emit(check_lora(gen, device, B * T, 4096, 11008, 8, 16, "f32_bank", reps,
                    by_request=True, share=True))
    emit(check_lora(gen, device, B * T, 4096, 11008, 8, 16, "f32_bank", reps,
                    dtype=torch.float32))
    # the other dense archs' projections at phase dense_family's rows (a
    # decode step: one row per request; a prefill dispatch: T per request)
    # over its 4 tenants: every variant at gemma-2b's and starcoder2-15b's
    # shapes, the served fp32 bank at olmo-1b's and yi-6b's shapes not held
    # above
    seen = {(4096, 4096), (4096, 11008)}
    for arch in DENSE_FAMILY:
        rows = dense_requests(arch)
        variants = (("f32_bank", "rank_mask", "int8_bank")
                    if arch in ("gemma-2b", "starcoder2-15b")
                    else ("f32_bank",))
        for K, N in projection_shapes(arch):
            if (K, N) in seen:
                continue
            seen.add((K, N))
            for M in (rows, rows * T):
                for variant in variants:
                    emit({**check_lora(gen, device, M, K, N, DENSE_TENANTS,
                                       16, variant, reps), "arch": arch})
    moe_kernels(gen, device, reps, dec_lengths, pre_lengths, T, seen)
    return main


def moe_kernels(gen, device, reps, dec_lengths, pre_lengths, T, seen):
    """The MoE archs' attention projections (the only ones batched LoRA
    runs there) not in ``seen``, at phase moe's rows over its 4 tenants,
    and dbrx-132b's attention (H 48 over Kv 8: G 6, a group count no other
    cell runs) at the serve cell's decode and prefill lengths."""
    for arch, _ in MOE_FAMILY:
        for K, N in projection_shapes(arch):
            if (K, N) in seen:
                continue
            seen.add((K, N))
            for M in (MOE_REQUESTS, MOE_REQUESTS * T):
                emit({**check_lora(gen, device, M, K, N, MOE_TENANTS, 16,
                                   "f32_bank", reps), "arch": arch})
    emit({**check_decode(gen, device, dec_lengths, 6, False, reps, H=48),
          "arch": "dbrx-132b"})
    emit({**check_prefill(gen, device, pre_lengths, T, 6, False, reps, H=48),
          "arch": "dbrx-132b"})


# ---------------------------------------------------------------------------
# phase 3: the serving path
# ---------------------------------------------------------------------------

def first_chunk_logits(eng, reqs, sc, backend):
    """Logits of the first prefill dispatch the engine would make for
    ``reqs`` (all slots admitted, fresh pool of ``sc.kv_dtype``, the
    registry's bank in ``backend``'s layout), through ``backend``."""
    import dataclasses
    import torch
    from repro_torch.serving.kv_cache import PagedKVCache, blocks_needed
    B = len(reqs)
    span = max(len(r.prompt) + sc.max_new_tokens for r in reqs)
    T = min(sc.prefill_chunk, span - 1)
    per = blocks_needed(span, sc.block_size)
    kv = PagedKVCache(B, sc.block_size, 1 + B * per, per)
    tokens = torch.zeros((B, T), dtype=torch.int32)
    n_new = torch.zeros((B,), dtype=torch.int32)
    for i, r in enumerate(reqs):
        kv.admit(i)
        n = min(T, len(r.prompt))
        require(kv.ensure(i, n), "first-chunk pool too small")
        tokens[i, :n] = torch.as_tensor(r.prompt[:n])
        n_new[i] = n
    dev = eng.device
    bt, lens = kv.device_tables(dev)
    ids = torch.tensor([eng.registry.acquire(r.client_id) for r in reqs],
                       dtype=torch.int32, device=dev)
    cache = eng.model.init_paged_decode_cache(1 + B * per, sc.block_size,
                                              kv_dtype=sc.kv_dtype)
    bank = eng.bank_for(dataclasses.replace(sc, paged_backend=backend))
    logits, _ = eng.model.prefill_step(
        eng.params, cache, tokens.to(dev), lens, n_new.to(dev),
        adapters=bank, lora_scale=eng.scale, adapter_ids=ids,
        block_tables=bt, paged_backend=backend)
    return logits, n_new


def compare_first_chunk(eng, reqs, sc, dtype_name, rel_tol, extra=None):
    """First prefill chunk through "cuda" and "torch" on fresh pools: the
    max logit error must stay within ``rel_tol`` of the largest logit, and
    each row's greedy token must agree wherever the torch path's top-2
    margin exceeds twice that error.  The "cuda" chunk must run
    batched_lora_matmul on the tile its activations pick: the tensor-core
    tile for bf16, the fp32 tile for fp32."""
    import torch
    from repro_torch import kernels
    kernels.reset_launch_counts()
    lc, n_new = first_chunk_logits(eng, reqs, sc, "cuda")
    lora_tiles = kernels.tile_counts()["batched_lora_matmul"]
    lt, _ = first_chunk_logits(eng, reqs, sc, "torch")
    valid = (torch.arange(lc.shape[1], device=lc.device)[None, :]
             < n_new.to(lc.device)[:, None])
    err = float((lc - lt).abs()[valid].max())
    scale = float(lt.abs()[valid].max())
    tol = rel_tol * scale
    rows = torch.arange(lc.shape[0], device=lc.device)
    last = n_new.to(lc.device).long() - 1
    top2 = torch.topk(lt[rows, last], 2, dim=-1).values
    decisive = (top2[:, 0] - top2[:, 1]) > 2 * err
    agree = lc[rows, last].argmax(-1) == lt[rows, last].argmax(-1)
    emit({"phase": "compare", "activations": dtype_name,
          "first_chunk_max_abs_logit_err": err, "max_abs_logit": scale,
          "tol": tol, "first_token_agree": int(agree.sum()),
          "rows": int(rows.numel()), "decisive_rows": int(decisive.sum()),
          "lora_tiles_cuda": lora_tiles, **(extra or {})})
    want, other = (("mma", "f32") if dtype_name == "bfloat16"
                   else ("f32", "mma"))
    require(lora_tiles[want] > 0 and lora_tiles[other] == 0,
            f"{dtype_name} first chunk: batched_lora_matmul tiles "
            f"{lora_tiles}, not only {want}")
    require(bool(torch.isfinite(lc).all()), "cuda logits not finite")
    require(err <= tol, f"{dtype_name} first-chunk logit error {err} > {tol}")
    require(bool(agree[decisive].all()),
            "greedy token differs on a row whose margin exceeds the error")
    return err


def require_mma_tile(tiles, name, what):
    """A bf16 run: kernel ``name`` ran its tensor-core tile, never its fp32
    tile."""
    t = tiles[name]
    require(t["mma"] > 0 and t["f32"] == 0,
            f"{what}: {name} tiles {t}; a bf16 run must launch the "
            "tensor-core tile and not the fp32 one")


def timed_generate(eng, reqs, sc):
    """Run ``generate_stream``; returns (streams, TTFT per request in s,
    seconds of the decode phase, tokens emitted in it, total seconds).  The
    decode phase starts at the last request's first token."""
    import torch
    outs = [[] for _ in reqs]
    first = [None] * len(reqs)
    stamps = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for rid, toks, _ in eng.generate_stream(reqs, sc):
        now = time.perf_counter()             # events follow a readback
        if first[rid] is None:
            first[rid] = now - t0
        outs[rid].extend(toks)
        stamps.append((now - t0, len(toks)))
    t_end = time.perf_counter() - t0
    t_dec0 = max(first)
    dec_tokens = sum(n for t, n in stamps if t > t_dec0)
    return outs, first, t_end - t_dec0, dec_tokens, t_end


def serve_phase(device, seed: int, n_requests: int, new_tokens: int,
                prompt_min: int, prompt_max: int, T: int, cfg=None,
                tenants: int = 8, rank: int = 16):
    """Returns (launch counts of the overlapped "cuda" run, the engine,
    the bf16 first-chunk logit error "cuda" vs "torch")."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_engine, ragged_requests
    from repro_torch.serving.engine import ServeConfig
    cfg = cfg or get_config(ARCH)
    t0 = time.perf_counter()
    eng = build_engine(cfg, tenants, device, seed, rank=rank)
    torch.cuda.synchronize()
    emit({"phase": "model", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "params": cfg.count_params(),
          "dtype": cfg.dtype, "tenants": tenants, "rank": rank,
          "init_s": time.perf_counter() - t0,
          "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9})
    reqs = ragged_requests(n_requests, tenants, cfg.vocab_size, prompt_min,
                           prompt_max, seed)
    sc = ServeConfig(batch_size=n_requests, max_new_tokens=new_tokens,
                     prefill_chunk=T, block_size=16, paged_backend="cuda")
    # warm-up on two short requests (cuBLAS handles, allocator)
    eng.generate(ragged_requests(2, tenants, cfg.vocab_size, 8, 16, seed + 1),
                 ServeConfig(batch_size=2, max_new_tokens=2, prefill_chunk=8,
                             paged_backend="cuda"))
    results = {}
    # the "cuda" path with overlapped dispatch (the default) and with the
    # synchronous loop, in turns (on, off, off, on: neither side always runs
    # first), then the plain "torch" path
    runs = [("cuda", True), ("cuda", False), ("cuda", False), ("cuda", True),
            ("torch", True)]
    for i, (backend, overlap) in enumerate(runs):
        sc.paged_backend, sc.overlap = backend, overlap
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        outs, ttft, dec_s, dec_tok, total_s = timed_generate(eng, reqs, sc)
        counts = kernels.launch_counts()
        tiles = kernels.tile_counts()
        st = eng.last_stats
        results.setdefault((backend, overlap), (outs, counts, tiles))
        require(outs == results[backend, overlap][0],
                f"serve: two {backend} runs with overlap={overlap} differ")
        emit({"phase": "serve", "backend": backend, "overlap": overlap,
              "turn": runs[:i + 1].count((backend, overlap)),
              "requests": len(reqs),
              "prompt_lens": [len(r.prompt) for r in reqs],
              "new_tokens": new_tokens, "prefill_chunk": T,
              "tokens": sum(len(o) for o in outs),
              "ttft_ms_p50": float(np.percentile(ttft, 50)) * 1e3,
              "ttft_ms_max": max(ttft) * 1e3,
              "decode_tokens": dec_tok, "decode_s": dec_s,
              "decode_tok_per_s": dec_tok / dec_s if dec_s > 0 else None,
              "total_s": total_s,
              "prefill_dispatches": st["prefill_dispatches"],
              "decode_dispatches": st["decode_dispatches"],
              "deferred_chunks": st["deferred_chunks"],
              "preemptions": st["preemptions"], "launches": counts,
              "tile_launches": tiles,
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
        for o in outs:
            require(len(o) == new_tokens and all(0 <= t < cfg.vocab_size
                                                 for t in o),
                    f"{backend}: a stream is malformed")
    cuda_counts = results["cuda", True][1]
    for name in kernels.SERVING:
        require(cuda_counts[name] > 0,
                f"kernel {name} was never launched on the serving path")
    for overlap in (True, False):
        for name in ("paged_prefill_attention", "batched_lora_matmul"):
            require_mma_tile(results["cuda", overlap][2], name,
                             f"serve overlap={overlap}")
    require(all(n == 0 for n in results["torch", True][1].values()),
            "the torch backend launched a CUDA kernel")
    # the same dispatches on the same inputs: bitwise equal streams
    require(results["cuda", True][0] == results["cuda", False][0],
            "serve: streams with overlap on and off differ")

    streams_c, streams_t = results["cuda", True][0], results["torch", True][0]
    matched = [next((i for i, (a, b) in enumerate(zip(c, t)) if a != b),
                    len(c)) for c, t in zip(streams_c, streams_t)]
    # bf16: the two paths round activations at different places (the LoRA
    # epilogue rounds once where the torch path rounds twice; the attention
    # tile rounds unnormalised probabilities where the torch path rounds
    # normalised ones), 224 projections deep.  The bound is a sanity bound:
    # a wrong mask or a lost LoRA term moves logits by O(their largest
    # value).
    err_bf16 = compare_first_chunk(
        eng, reqs, sc, "bfloat16", rel_tol=0.1,
        extra={"stream_prefix_matched": matched,
               "stream_tokens_agree_fraction":
                   sum(matched) / sum(len(c) for c in streams_c)})
    # fp32 activations over the same bf16 weights: the paths differ in
    # summation order only, except that K/V are stored in bf16 pools, where
    # that order noise now and then flips a rounding by one bf16 ulp; 32
    # layers carry those flips to the logits (bring-up runs on an H100:
    # 0.23% of the largest logit), so the bound is 1%
    from repro_torch.models.api import Model
    from repro_torch.serving.engine import MultiTenantEngine
    cfg32 = cfg.with_overrides(dtype="float32")
    eng32 = MultiTenantEngine(Model(cfg32, device), cfg32, eng.params,
                              eng.registry)
    compare_first_chunk(eng32, reqs, sc, "float32", rel_tol=1e-2)
    for i, overlap in enumerate((True, False, False, True)):
        profile_phase(eng, reqs, dataclasses.replace(sc, overlap=overlap),
                      check=i == 0)
    return cuda_counts, eng, err_bf16


KERNEL_FAMILIES = (("paged_decode_split_kernel", "paged_attention (split)"),
                   ("paged_decode_combine_kernel",
                    "paged_attention (combine)"),
                   ("paged_prefill_mma_kernel",
                    "paged_prefill_attention (tensor-core tile)"),
                   ("paged_prefill_kernel",
                    "paged_prefill_attention (fp32 tile)"),
                   ("lora_mma_shrink_kernel", "batched_lora_matmul (shrink)"),
                   ("lora_mma_zprep_kernel",
                    "batched_lora_matmul (z operand prep)"),
                   ("lora_mma_bprep_kernel",
                    "batched_lora_matmul (B operand prep)"),
                   ("lora_mma_reduce_kernel",
                    "batched_lora_matmul (split-K reduction + epilogue)"),
                   ("lora_mma_kernel",
                    "batched_lora_matmul (tensor-core tile + LoRA stages)"),
                   ("lora_matmul_kernel",
                    "batched_lora_matmul (fp32 tile + epilogue)"),
                   ("lora_shrink_kernel", "batched_lora_matmul (fp32 shrink)"))
TRAIN_FAMILIES = (("lora_mma_shrink_kernel", "lora_matmul (shrink)"),
                  ("lora_mma_zprep_kernel", "lora_matmul (z operand prep)"),
                  ("lora_mma_bprep_kernel", "lora_matmul (B operand prep)"),
                  ("lora_mma_reduce_kernel",
                   "lora_matmul (split-K reduction + epilogue)"),
                  ("lora_mma_kernel",
                   "lora_matmul (tensor-core tile + LoRA stages)"),
                  ("single_lora_xw_kernel", "lora_matmul (fp32 tile + epilogue)"),
                  ("single_lora_xa_kernel", "lora_matmul (fp32 shrink)"),
                  ("flash_attn_mma_kernel",
                   "flash_attention (tensor-core tile)"),
                  ("flash_attn_fwd_kernel", "flash_attention (fp32 tile)"),
                  ("dual_lora_", "dual_lora_matmul"),
                  *((k, "cuBLAS matmuls (plain backward, lm_head)")
                    for k in ("gemm", "nvjet", "xmma", "cutlass")))
# a bf16 fused evaluation runs dual_lora_matmul for every projection, so
# the LoRA tile's kernels there are its parts
FUSED_EVAL_FAMILIES = (("dual_lora_merge_kernel",
                        "dual_lora_matmul (pair merge)"),
                       ("lora_mma_shrink_kernel", "dual_lora_matmul (shrink)"),
                       ("lora_mma_zprep_kernel",
                        "dual_lora_matmul (z operand prep)"),
                       ("lora_mma_bprep_kernel",
                        "dual_lora_matmul (B operand prep)"),
                       ("lora_mma_reduce_kernel",
                        "dual_lora_matmul (split-K reduction + epilogue)"),
                       ("lora_mma_kernel",
                        "dual_lora_matmul (tensor-core tile + LoRA stages)"),
                       ("flash_attn_mma_kernel",
                        "flash_attention (tensor-core tile)"),
                       *((k, "cuBLAS matmuls (lm_head)")
                         for k in ("gemm", "nvjet", "xmma", "cutlass")))


def traced(fn, families, other: str, check: bool = False, ranges=()):
    """Run ``fn`` once under ``torch.profiler`` (CPU + CUDA activity);
    returns (wall ms, {family: device ms}) with kernels sorted into
    ``families`` by name.  A kernel of the port's own (a name with
    ``lora``, ``attn`` or ``paged``) that no family claims is a fault.
    Tracing slows the host, so the idle share it gives is an upper
    bound.  The device events are read from the profiler's raw results:
    ``key_averages()`` builds a Python event per CPU op as well, minutes
    for a trace of some seconds of serving.  With ``check`` the busy time
    is also read through ``key_averages()``, the two must agree within
    0.1%, and that reading comes back as a third value.

    ``ranges``: ((``record_function`` name, family), ...), innermost
    first: a kernel whose launching host op (the profiler's correlation
    ids) started inside such a range belongs to its family, whatever its
    name; the ranges' own device events are left out.  A kernel the trace
    links to no host op and no name claims goes to ``other`` marked
    "launch not linked"."""
    import bisect

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = list(prof.profiler.kineto_results.events())
    # host ops and ranges only, not the CUDA runtime's calls ("cuda...",
    # "cu..."), which number their correlation ids apart: a kernel links
    # to the op it was launched under
    host = {ev.correlation_id(): ev for ev in events
            if ranges and ev.device_type() != DeviceType.CUDA
            and not ev.name().startswith("cu")}
    spans = {r: sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns())
                       for ev in host.values() if ev.name() == r)
             for r, _ in ranges}

    def in_range(r, t):
        i = bisect.bisect_right(spans[r], (t, float("inf"))) - 1
        return i >= 0 and spans[r][i][0] <= t <= spans[r][i][1]

    fam = {}
    for ev in events:
        if ev.device_type() != DeviceType.CUDA or ev.name() in spans:
            continue
        key = ev.name()
        parent = host.get(ev.linked_correlation_id())
        name = None if parent is None else next(
            (f for r, f in ranges if in_range(r, parent.start_ns())), None)
        name = name or next((f for k, f in families if k in key), None)
        require(name is not None or not any(
            k in key for k in ("lora", "attn", "paged")),
            f"traced kernel {key[:120]} belongs to no family")
        if name is None:
            name = (f"{other}; launch not linked" if ranges and parent is None
                    else other)
        fam[name] = fam.get(name, 0.0) + ev.duration_ns() / 1e6
    if check:
        busy = sum(fam.values())
        ka = sum((getattr(ev, "self_device_time_total", None)
                  or getattr(ev, "self_cuda_time_total", 0))
                 for ev in prof.key_averages()
                 if ev.device_type == DeviceType.CUDA) / 1e3
        require(abs(ka - busy) <= 1e-3 * busy, f"device busy ms from the "
                f"raw events {busy} differs from key_averages' {ka}")
        return wall * 1e3, fam, ka
    return wall * 1e3, fam


def _profile_line(fam, wall_ms, **extra):
    busy_ms = sum(fam.values())
    return {**extra, "traced_wall_ms": wall_ms,
            "device_busy_ms": busy_ms if fam else "not measured",
            "device_idle_share": (1 - busy_ms / wall_ms) if fam
            else "not measured",
            "device_ms_by_kernel": dict(sorted(fam.items(),
                                               key=lambda kv: -kv[1]))}


def _decode_share(fam):
    """paged_attention's device ms (split + combine) in a traced serving
    run and its share of the busy time; the run must have launched it."""
    ms = sum(v for k, v in fam.items() if k.startswith("paged_attention ("))
    require(ms > 0, "the traced serving run shows no paged_attention kernel")
    return {"paged_attention_ms": ms,
            "paged_attention_share_of_busy": ms / sum(fam.values())}


def profile_phase(eng, reqs, sc, new_tokens: int = 8, check: bool = False):
    """One traced serving run: device time by kernel family and the
    device's idle share of the traced wall time; the untraced runs above
    give the end-to-end numbers.  ``check``: also read the busy time
    through ``key_averages()`` (see ``traced``)."""
    import dataclasses
    sc2 = dataclasses.replace(sc, max_new_tokens=new_tokens,
                              paged_backend="cuda")
    wall_ms, fam, *ka = traced(
        lambda: eng.generate(reqs, sc2), KERNEL_FAMILIES,
        "other device work (torch: lm_head, norms, rope, scatter, "
        "sampling, copies)", check=check)
    emit(_profile_line(fam, wall_ms, phase="profile", overlap=sc.overlap,
                       requests=len(reqs), new_tokens=new_tokens,
                       **({"key_averages_busy_ms": ka[0]} if ka else {}),
                       **_decode_share(fam)))


# ---------------------------------------------------------------------------
# phase 3b: an open-loop trace through the serve phase's engine
# ---------------------------------------------------------------------------

def _trace_line(rep, **extra):
    st = rep["last_stats"]
    return {**extra, "mode": rep["mode"], "unit": rep["unit"],
            "completed": rep["completed"],
            "emitted_tokens": rep["emitted_tokens"],
            "elapsed": rep["elapsed"],
            "goodput_tok_per_unit": rep["goodput_tok_per_unit"],
            "ttft": rep["ttft"], "tpot": rep["tpot"],
            "per_class": rep["per_class"],
            "queue_waits": st["classes"],
            **{k: st[k] for k in ("prefill_dispatches", "decode_dispatches",
                                  "deferred_chunks", "preemptions")}}


def serve_trace_phase(eng, seed: int, err_bf16: float, n_requests: int = 16):
    """An open-loop Poisson trace (``serving/trace.py``) through the serve
    phase's engine: logical mode (arrivals mapped to rounds) with overlap
    on and off, streams bitwise equal; realtime mode with overlap on and
    off, TTFT from each scheduled arrival, TPOT, goodput and wall-clock
    queue waits, streams held to the logical ones by the margin rule (the
    batch make-up differs); one traced realtime run."""
    import dataclasses

    import torch
    from repro_torch import kernels
    from repro_torch.serving.engine import ServeConfig
    from repro_torch.serving.kv_cache import kv_bytes_per_block
    from repro_torch.serving.trace import run_trace, synth_trace
    cfg = eng.cfg
    trace = synth_trace(seed, n_requests, arrival="poisson", rate=2.0,
                        prompt_mean=256, prompt_sigma=0.6, prompt_max=1024,
                        out_mean=32, out_sigma=0.6, out_max=64,
                        clients=tuple(f"client{i}" for i in range(8)),
                        vocab_size=cfg.vocab_size)
    # 8 slots of 68 blocks of 16 tokens (1088, the longest span)
    sc = ServeConfig(batch_size=8, block_size=16, prefill_chunk=256,
                     num_blocks=545, max_blocks_per_slot=68,
                     paged_backend="cuda")
    emit({"phase": "serve_trace_config", "requests": n_requests,
          "arrival": "poisson", "rate_per_s": 2.0,
          "arrivals_s": [e.arrival_s for e in trace],
          "prompt_lens": [len(e.prompt) for e in trace],
          "max_new_tokens": [e.max_new_tokens for e in trace],
          "priorities": [e.priority for e in trace],
          "clients": [e.client_id for e in trace],
          "batch": 8, "block_size": 16, "prefill_chunk": 256,
          "num_blocks": 545, "max_blocks_per_slot": 68,
          "scan_chunk": sc.scan_chunk, "rounds_per_s": 8.0,
          "pool_gb": 545 * kv_bytes_per_block(
              16, cfg.n_kv_heads, cfg.resolved_head_dim, "f32")
          * cfg.n_layers / 1e9})

    def check(rep, what):
        require(rep["completed"] == n_requests,
                f"{what}: {rep['completed']} of {n_requests} completed")
        for rid, e in enumerate(trace):
            got = rep["streams"].get(rid, [])
            require(len(got) == e.max_new_tokens and all(
                0 <= t < cfg.vocab_size for t in got),
                f"{what}: stream {rid} is malformed")

    logical = {}
    for overlap in (True, False):
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = run_trace(eng, dataclasses.replace(sc, overlap=overlap), trace,
                        rounds_per_s=8.0)
        wall_s = time.perf_counter() - t0
        counts, tiles = kernels.launch_counts(), kernels.tile_counts()
        emit(_trace_line(rep, phase="serve_trace", overlap=overlap,
                         wall_s=wall_s, launches=counts,
                         tile_launches=tiles))
        check(rep, f"serve_trace logical overlap={overlap}")
        for name in ("paged_prefill_attention", "batched_lora_matmul"):
            require_mma_tile(tiles, name, f"serve_trace overlap={overlap}")
        if overlap:
            for name in kernels.SERVING:
                require(counts[name] > 0, f"serve_trace: kernel {name} was "
                        "never launched in the overlapped run")
        logical[overlap] = rep
    require(logical[True]["streams"] == logical[False]["streams"],
            "serve_trace: logical streams with overlap on and off differ")
    require(logical[True]["last_stats"]["deferred_chunks"] > 0,
            "serve_trace: no decode chunk was deferred")

    reqs = [e.request() for e in trace]
    want = [logical[True]["streams"][rid] for rid in range(n_requests)]
    for overlap in (True, False, False, True):      # in turns
        rep = run_trace(eng, dataclasses.replace(sc, overlap=overlap), trace,
                        realtime=True, time_scale=1.0)
        check(rep, f"serve_trace realtime overlap={overlap}")
        got = [rep["streams"][rid] for rid in range(n_requests)]
        t0 = time.perf_counter()
        matched = streams_by_margin(
            eng, reqs, sc, got, want, err_bf16,
            f"serve_trace realtime overlap={overlap} vs logical")
        emit(_trace_line(rep, phase="serve_trace", overlap=overlap,
                         matched_logical_prefix=matched,
                         streams_equal_logical=got == want,
                         margin_check_s=time.perf_counter() - t0))
    t0 = time.perf_counter()
    wall_ms, fam = traced(
        lambda: run_trace(eng, sc, trace, realtime=True, time_scale=1.0),
        KERNEL_FAMILIES, "other device work (torch: lm_head, norms, rope, "
        "scatter, sampling, copies)")
    # the profiler's own cost after the run: reading its events back
    emit(_profile_line(fam, wall_ms, phase="profile_serve_trace",
                       overlap=True, mode="realtime", requests=n_requests,
                       trace_processing_s=time.perf_counter() - t0
                       - wall_ms / 1e3, **_decode_share(fam)))


# ---------------------------------------------------------------------------
# phase 4: the serving options (int8 K/V, ragged int8 bank, prefix cache,
# speculative decoding)
# ---------------------------------------------------------------------------

def feed_chunks(eng, kv, cache, slot, seq, sc, backend):
    """Feed ``seq[lengths[slot]:]`` to ``slot`` of ``kv`` as a batch of one,
    in ``sc.prefill_chunk``-token prefill dispatches through ``backend``
    (blocks sealed as they fill, as the engine does).  Returns ([(first
    position, logits (n, V))], cache)."""
    import dataclasses

    import torch
    dev = eng.device
    T = sc.prefill_chunk
    bank = eng.bank_for(dataclasses.replace(sc, paged_backend=backend))
    ids = torch.tensor([eng.registry.acquire(seq.client_id)],
                       dtype=torch.int32, device=dev)
    toks = [int(t) for t in seq.prompt]
    out, pos = [], int(kv.lengths[slot])
    while pos < len(toks):
        n = min(T, len(toks) - pos)
        require(kv.ensure(slot, pos + n), "teacher-forcing pool too small")
        bt, lens = kv.device_tables(dev)
        chunk = torch.zeros((1, T), dtype=torch.int32)
        chunk[0, :n] = torch.tensor(toks[pos:pos + n])
        logits, cache = eng.model.prefill_step(
            eng.params, cache, chunk.to(dev), lens[slot:slot + 1],
            torch.tensor([n], dtype=torch.int32, device=dev), adapters=bank,
            lora_scale=eng.scale, adapter_ids=ids,
            block_tables=bt[slot:slot + 1], paged_backend=backend)
        kv.advance(slot, n, tokens=toks[pos:pos + n])
        out.append((pos, logits[0, :n]))
        pos += n
    return out, cache


def _fresh_pool(eng, sc, n_tokens, slots=1):
    from repro_torch.serving.kv_cache import PagedKVCache, blocks_needed
    per = blocks_needed(n_tokens, sc.block_size)
    kv = PagedKVCache(slots, sc.block_size, 1 + slots * per, per,
                      prefix_cache=True)
    return kv, eng.model.init_paged_decode_cache(1 + slots * per,
                                                 sc.block_size,
                                                 kv_dtype=sc.kv_dtype)


def next_token_margin(eng, req, tokens, sc, backend="cuda"):
    """Top-2 margin of the logits after ``req.prompt + tokens`` (fresh
    pool, prefill chunks): the margin of the stream's next greedy
    decision."""
    import dataclasses

    import numpy as np
    import torch
    seq = dataclasses.replace(req, prompt=np.concatenate(
        [np.asarray(req.prompt, np.int32), np.asarray(tokens, np.int32)]))
    kv, cache = _fresh_pool(eng, sc, len(seq.prompt))
    kv.admit(0)
    out, _ = feed_chunks(eng, kv, cache, 0, seq, sc, backend)
    top2 = torch.topk(out[-1][1][-1], 2).values
    return float(top2[0] - top2[1])


def streams_by_margin(eng, reqs, sc, got, want, err, what):
    """Streams ``got`` against ``want``: equal wherever the top-2 margin
    exceeds twice ``err``.  At each stream's first difference the margin
    of that decision (teacher-forced on ``want``'s history) must be at most
    2 err.  Returns each stream's matched-prefix length."""
    matched = []
    for req, g, w in zip(reqs, got, want):
        t = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                 min(len(g), len(w)))
        matched.append(t)
        if t < min(len(g), len(w)):
            m = next_token_margin(eng, req, w[:t], sc)
            require(m <= 2 * err,
                    f"{what}: {req.client_id} differs at token {t} where the "
                    f"margin {m} exceeds 2 x {err}")
    return matched


def warm_chunk_check(eng32, req_a, req_b, prefix_len, sc):
    """The first suffix chunk of ``req_b`` after a prefix hit on blocks that
    ``req_a`` (same tenant, same prefix) sealed, against the same positions
    of ``req_b`` prefilled cold, fp32 activations, through "cuda": the max
    logit difference must stay within 1% of the largest logit."""
    import torch
    kv, cache = _fresh_pool(eng32, sc, len(req_a.prompt) + len(req_b.prompt),
                            slots=2)
    scope = (req_a.client_id, eng32.registry.version(req_a.client_id))
    kv.admit(0, scope, req_a.prompt)
    _, cache = feed_chunks(eng32, kv, cache, 0, req_a, sc, "cuda")
    kv.release(0)
    hit = kv.admit(1, scope, req_b.prompt)
    require(hit >= prefix_len, f"warm-chunk check: hit {hit} tokens, under "
            f"the {prefix_len}-token prefix")
    warm, _ = feed_chunks(eng32, kv, cache, 1, req_b, sc, "cuda")
    kv2, cache2 = _fresh_pool(eng32, sc, len(req_b.prompt))
    kv2.admit(0)
    cold, _ = feed_chunks(eng32, kv2, cache2, 0, req_b, sc, "cuda")
    cold_all = torch.cat([lg for _, lg in cold])       # every position
    pos0, lw = warm[0]
    lc = cold_all[pos0:pos0 + lw.shape[0]]
    err = float((lw - lc).abs().max())
    top = float(lc.abs().max())
    emit({"phase": "warm_chunk", "activations": "float32",
          "prefix_hit_tokens": hit, "first_suffix_position": pos0,
          "positions": int(lw.shape[0]), "max_abs_logit_err": err,
          "max_abs_logit": top, "tol": 1e-2 * top})
    require(err <= 1e-2 * top, f"warm suffix chunk logit error {err} > "
            f"{1e-2 * top}")


def bank_bytes(registry):
    """(ragged int8 bank, its kernel view, a uniform rank-16 fp32 bank of
    the same capacity) in bytes."""
    from repro_torch.core.lora import block_target_shapes, tree_leaves
    own = sum(t.numel() * t.element_size()
              for _, t in tree_leaves(registry.bank()))
    view = sum(t.numel() * t.element_size()
               for _, t in tree_leaves(registry.kernel_bank()))
    cfg = registry._cfg
    per_layer = sum(din * 16 + 16 * dout
                    for tmap in block_target_shapes(cfg).values()
                    for din, dout in tmap.values())
    uniform = 4 * registry.capacity * cfg.n_layers * per_layer
    return own, view, uniform


def tenant_text(rng, tenant: int, n_tokens: int):
    """``n_tokens`` byte-tokenized log-anomaly examples (prompt, answer) of
    ``tenant``'s log source: the repo's FDLoRA data, templated text of the
    kind a tenant sends, in the byte tokenizer's ids."""
    import numpy as np
    from repro_torch.data.synthetic import gen_log_dataset
    from repro_torch.data.tokenizer import ByteTokenizer
    tok = ByteTokenizer()
    ids = []
    while len(ids) < n_tokens:
        for ex in gen_log_dataset(rng, 8, tenant):
            ids += tok.encode(ex.prompt + ex.answer + "\n", add_bos=False)
    return np.asarray(ids[:n_tokens], np.int32)


def serve_options_phase(device, seed: int, params, cfg, T: int = 256,
                        prefix_len: int = 512, new_tokens: int = 32):
    """llama2-7b, 32 layers, bf16: int8 K/V, a ragged int8 bank, prefix
    caching on a pool pinned below residency, then speculative decoding.
    Returns the cold run's launch counts."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core.lora import init_adapters
    from repro_torch.models.api import Model
    from repro_torch.serving.engine import (MultiTenantEngine, Request,
                                            ServeConfig)
    from repro_torch.serving.kv_cache import blocks_needed, kv_bytes_per_block
    from repro_torch.serving.registry import AdapterRegistry

    registry = AdapterRegistry(cfg, capacity=8, ranks=[4, 8, 16],
                               bank_dtype="int8", device=device)
    tenant_ranks = [4, 4, 8, 8, 16, 16]
    for i, rank in enumerate(tenant_ranks):
        # A ~ N(0, 1) / r, so x·A·B grows like 1 / sqrt(r) at a fixed B
        # spread; B ~ N(0, (0.02 sqrt(r / 16))^2) gives every tenant the
        # update size of the serve phase's rank-16 adapters (a lower-rank
        # adapter is not a larger one)
        b_std = 0.02 * (rank / 16) ** 0.5
        ad_p = init_adapters(cfg, rank, seed=seed + 200 + 2 * i,
                             device=device, b_std=b_std)
        ad_s = init_adapters(cfg, rank, seed=seed + 201 + 2 * i,
                             device=device, b_std=b_std)
        registry.register_dual(f"tenant{i}", ad_p, ad_s, [0.6, 0.6])
        del ad_p, ad_s
    eng = MultiTenantEngine(Model(cfg, device), cfg, params, registry)
    own, view, uniform = bank_bytes(registry)
    emit({"phase": "bank_bytes", "capacity": registry.capacity,
          "bucket_ranks": registry.bucket_ranks,
          "bucket_sizes": registry.bucket_sizes,
          "slot_ranks": registry.slot_ranks().tolist(),
          "ragged_int8_bank_bytes": own,
          "kernel_view_bytes": view,
          "uniform_rank16_fp32_bank_bytes": uniform,
          "uniform_over_ragged": uniform / own})

    # two requests per tenant: the tenant's 512-token prefix (a few-shot
    # context of its own log source) plus a seeded suffix of 64-256 tokens
    # of further log examples; every tenant's first request, then the
    # seconds
    rng = np.random.default_rng(seed + 300)
    prefixes = [tenant_text(rng, i, prefix_len)
                for i in range(len(tenant_ranks))]
    reqs = []
    for _ in range(2):
        for i, pre in enumerate(prefixes):
            suf = tenant_text(rng, i, int(rng.integers(64, 257)))
            reqs.append(Request(f"tenant{i}", np.concatenate([pre, suf])))
    spans = [blocks_needed(len(r.prompt) + new_tokens, 16) for r in reqs]
    resident = sum(sorted(spans)[-8:])          # 8 slots of the longest
    num_blocks = 1 + (3 * resident) // 4
    sc = ServeConfig(batch_size=8, max_new_tokens=new_tokens,
                     prefill_chunk=T, block_size=16, num_blocks=num_blocks,
                     kv_dtype="int8", prefix_cache=True,
                     paged_backend="cuda")
    emit({"phase": "serve_options_config", "requests": len(reqs),
          "prompt_lens": [len(r.prompt) for r in reqs],
          "prefix_len": prefix_len, "new_tokens": new_tokens,
          "tenant_ranks": tenant_ranks, "batch": sc.batch_size,
          "prefill_chunk": T, "block_size": 16,
          "blocks_for_8_resident": resident, "num_blocks": num_blocks,
          "pool_gb": num_blocks * kv_bytes_per_block(
              16, cfg.n_kv_heads, cfg.resolved_head_dim, "int8")
          * cfg.n_layers / 1e9})

    def run(name, reqs_, sc_):
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        outs, ttft, dec_s, dec_tok, total_s = timed_generate(eng, reqs_, sc_)
        counts = kernels.launch_counts()
        tiles = kernels.tile_counts()
        st = eng.last_stats
        line = {"phase": "serve_options", "run": name,
                "requests": len(reqs_), "tokens": sum(len(o) for o in outs),
                "ttft_ms_p50": float(np.percentile(ttft, 50)) * 1e3,
                "ttft_ms_max": max(ttft) * 1e3,
                "decode_tokens": dec_tok, "decode_s": dec_s,
                "decode_tok_per_s": dec_tok / dec_s if dec_s > 0 else None,
                "total_s": total_s,
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                "launches": counts, "tile_launches": tiles,
                **{k: st[k] for k in (
                    "prefill_dispatches", "decode_dispatches",
                    "verify_dispatches", "preemptions", "prompt_tokens",
                    "prefix_hit_tokens", "prefix_hit_rate",
                    "prefix_pool_reused", "prefix_evictions",
                    "drafted_tokens", "accepted_tokens", "acceptance_rate",
                    "rollback_tokens", "kv_dtype")}}
        emit(line)
        for o in outs:
            require(len(o) == sc_.max_new_tokens and all(
                0 <= t < cfg.vocab_size for t in o),
                f"serve_options {name}: a stream is malformed")
        for kernel in ("paged_prefill_attention", "batched_lora_matmul"):
            require_mma_tile(tiles, kernel, f"serve_options {name}")
        return outs, st, counts

    # 1. cold: prefix hits inside the call, preemption, every serving kernel
    eng.release_prefix_cache()
    cold, st_cold, counts = run("cold", reqs, sc)
    require(st_cold["prefix_hit_tokens"] > 0, "cold run: no prefix hit")
    require(st_cold["preemptions"] > 0, "cold run: no preemption")
    for name in kernels.SERVING:
        require(counts[name] > 0,
                f"kernel {name} was never launched on the options path")
    # 2. warm: the same requests against the pool kept by the cold run
    warm, st_warm, _ = run("warm", reqs, sc)
    require(st_warm["prefix_pool_reused"], "warm run: pool not reused")
    require(st_warm["prefix_hit_rate"] > st_cold["prefix_hit_rate"],
            "warm run: hit rate not above the cold run's")
    # 3. speculative: each prompt extended by its own first 16 greedy tokens
    # from the cold run, so the drafter finds runs to copy
    spec_reqs = [dataclasses.replace(r, prompt=np.concatenate(
        [r.prompt, np.asarray(o[:16], np.int32)])) for r, o in zip(reqs, cold)]
    sc_spec = dataclasses.replace(sc, spec_decode=True, spec_k=4)
    spec, st_spec, _ = run("spec", spec_reqs, sc_spec)
    require(st_spec["verify_dispatches"] > 0, "spec run: no verify dispatch")
    require(st_spec["accepted_tokens"] > 0, "spec run: no draft accepted")

    # 4. the properties, to stated tolerances.  First-chunk logits "cuda"
    # vs "torch" with int8 K/V and the ragged int8 bank (compare_first_chunk's
    # bounds); the first 8 requests, as one dispatch would hold them.
    first = reqs[:8]
    err_bf16 = compare_first_chunk(eng, first, sc, "bfloat16", rel_tol=0.1,
                                   extra={"kv_dtype": "int8",
                                          "bank": "ragged int8"})
    # fp32 activations: with bf16 pools (the serve phase's) the paths differ
    # by summation order, and that noise flips a pool rounding by one bf16
    # ulp now and then: 1%.  int8 pools turn the same noise into flips of
    # one int8 step, amax/127 of a (position, kv-head) row, about 3x a bf16
    # ulp of a typical element (|x| ~ amax/3), so flips move logits about
    # 3x as far: 3%.  A wrong scale, mask or bucket moves them by O(10%).
    cfg32 = cfg.with_overrides(dtype="float32")
    eng32 = MultiTenantEngine(Model(cfg32, device), cfg32, params, registry)
    compare_first_chunk(eng32, first, dataclasses.replace(sc, kv_dtype="f32"),
                        "float32", rel_tol=1e-2,
                        extra={"kv_dtype": "f32", "bank": "ragged int8"})
    compare_first_chunk(eng32, first, sc, "float32", rel_tol=3e-2,
                        extra={"kv_dtype": "int8", "bank": "ragged int8"})
    warm_chunk_check(eng32, reqs[0], reqs[6], prefix_len, sc)
    del eng32
    # streams: warm vs cold and spec vs cold (the spec stream's first 16
    # tokens continue where the cold stream's first 16 ended), equal
    # wherever the margin exceeds twice the bf16 cuda-vs-torch error
    m_warm = streams_by_margin(eng, reqs, sc, warm, cold, err_bf16,
                               "warm vs cold")
    m_spec = streams_by_margin(eng, spec_reqs, sc,
                               [o[:16] for o in spec],
                               [o[16:32] for o in cold], err_bf16,
                               "spec vs cold")
    emit({"phase": "serve_options_streams", "err_bound": 2 * err_bf16,
          "warm_vs_cold_matched": m_warm,
          "spec_vs_cold_matched_of_16": m_spec})
    # one traced warm run, 8 new tokens: device time by kernel family
    sc8 = dataclasses.replace(sc, max_new_tokens=8)
    wall_ms, fam = traced(lambda: eng.generate(reqs, sc8), KERNEL_FAMILIES,
                          "other device work (torch: lm_head, norms, rope, "
                          "scatter-quantize, sampling, copies)")
    st = eng.last_stats
    emit(_profile_line(fam, wall_ms, phase="profile_serve_options",
                       requests=len(reqs), new_tokens=8,
                       **_decode_share(fam),
                       **{k: st[k] for k in (
                           "prefix_pool_reused", "prefix_hit_rate",
                           "prefill_dispatches", "decode_dispatches")}))
    eng.release_prefix_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 4b: sharded serving and hot-swap across shards
# ---------------------------------------------------------------------------

def fused_trees(cfg, device, tenants=8, ranks=None):
    """Each tenant's Eq. 7-fused adapter: the serve cell's seeds (those of
    ``build_engine``), tenant i at ``ranks[i % len]`` with ``ranks``, built
    once for every registry of the phase."""
    from repro_torch.core.dual_lora import merge
    from repro_torch.core.lora import init_adapters
    trees = []
    for i in range(tenants):
        rank = ranks[i % len(ranks)] if ranks else 16
        # B ~ N(0, (0.02 sqrt(r / 16))^2), as in serve_options: a rank-r
        # tenant's update the size of a rank-16 one's (at a fixed B spread
        # x·A·B grows like 1 / sqrt(r), and unscaled rank-4 updates, twice
        # the size, carry bf16 noise to 62% of the largest first-chunk
        # logit; PERF.md, the sharded phase)
        pair = [init_adapters(cfg, rank, seed=10 + 2 * i + j, device=device,
                              b_std=0.02 * (rank / 16) ** 0.5)
                for j in (0, 1)]
        trees.append(merge(*pair, [0.6, 0.6]))
    return trees


def sharded_engine(device, params, cfg, shards, trees, capacity=8,
                   ranks=None, bank_dtype="f32"):
    """A MultiTenantEngine over a ShardedAdapterRegistry of ``shards``
    shards holding ``trees`` (client i the i-th), and the ms of its first
    bank build (the concatenation of the shards' banks, and for a ragged
    bank the kernel view)."""
    import torch
    from repro_torch.models.api import Model
    from repro_torch.serving.engine import MultiTenantEngine
    from repro_torch.serving.sharded import ShardedAdapterRegistry
    reg = ShardedAdapterRegistry(cfg, capacity, num_shards=shards,
                                 ranks=ranks, bank_dtype=bank_dtype,
                                 device=device)
    for i, tree in enumerate(trees):
        reg.register(f"client{i}", tree)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reg.kernel_bank()
    torch.cuda.synchronize()
    return (MultiTenantEngine(Model(cfg, device), cfg, params, reg),
            (time.perf_counter() - t0) * 1e3)


def sharded_phase(device, seed: int, params, cfg, prompt_lens, T: int = 256,
                  new_tokens: int = 32):
    """llama2-7b, 32 layers, bf16: the serve cell's 8 requests and 8
    tenants' rank-16 fused adapters in a ShardedAdapterRegistry of
    capacity 8, 8 slots, through "cuda" with overlap on: num_shards 1, 2
    and 4 (streams bitwise equal), the prefix cache cold then warm at 2
    shards on a pinned pool, int8 K/V over a ragged int8 bank (ranks 4, 8,
    16) at 1 and 2 shards, and a hot-swap at 2 shards that re-registers
    one client after the first decode round.  Returns (the launch counts
    of the 2-shard run, its engine at 1 shard for the fixed phase)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core.lora import tree_leaves
    from repro_torch.launch.serve import ragged_requests, register_client
    from repro_torch.models.api import Model
    from repro_torch.serving.engine import MultiTenantEngine, ServeConfig
    from repro_torch.serving.kv_cache import blocks_needed
    cfg = cfg.with_overrides(lora_rank=16)
    reqs = ragged_requests(8, 8, cfg.vocab_size, 128, 1024, seed)
    require(sorted(len(r.prompt) for r in reqs) == list(prompt_lens),
            "the sharded phase's requests are not the serve cell's")
    sc = ServeConfig(batch_size=8, max_new_tokens=new_tokens,
                     prefill_chunk=T, block_size=16, paged_backend="cuda")
    per = blocks_needed(max(len(r.prompt) for r in reqs) + new_tokens, 16)
    # a pool pinned at full residency: 8 slots x the longest span, which
    # splits into whole shards at 1, 2 and 4
    pinned = dict(num_blocks=1 + 8 * per, max_blocks_per_slot=per)

    def run(name, eng, sc_, reqs_=reqs):
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        outs, ttft, dec_s, dec_tok, total_s = timed_generate(eng, reqs_, sc_)
        counts, tiles = kernels.launch_counts(), kernels.tile_counts()
        st = eng.last_stats
        emit({"phase": "sharded", "run": name, "num_shards": sc_.num_shards,
              "kv_dtype": sc_.kv_dtype, "prefix_cache": sc_.prefix_cache,
              "requests": len(reqs_), "tokens": sum(len(o) for o in outs),
              "ttft_ms_p50": float(np.percentile(ttft, 50)) * 1e3,
              "ttft_ms_max": max(ttft) * 1e3, "decode_tokens": dec_tok,
              "decode_s": dec_s,
              "decode_tok_per_s": dec_tok / dec_s if dec_s > 0 else None,
              "total_s": total_s,
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
              "launches": counts, "tile_launches": tiles,
              **{k: st[k] for k in (
                  "prefill_dispatches", "decode_dispatches", "preemptions",
                  "prefix_hit_tokens", "prefix_pool_reused",
                  "adapter_bank_refreshes", "deferred_chunks")},
              "shard_placements": st.get("shard_placements")})
        for o in outs:
            require(len(o) == new_tokens and all(0 <= t < cfg.vocab_size
                                                 for t in o),
                    f"sharded {name}: a stream is malformed")
        for name_ in kernels.SERVING:
            require(counts[name_] > 0,
                    f"sharded {name}: kernel {name_} never launched")
        for kernel in ("paged_prefill_attention", "batched_lora_matmul"):
            require_mma_tile(tiles, kernel, f"sharded {name}")
        return outs, st, counts

    streams, engines, concat_ms = {}, {}, {}
    trees = fused_trees(cfg, device)
    for shards in (1, 2, 4):
        eng, concat_ms[f"f32_{shards}"] = sharded_engine(
            device, params, cfg, shards, trees)
        if shards == 1:                 # warm-up (cuBLAS handles, allocator)
            eng.generate(ragged_requests(2, 8, cfg.vocab_size, 8, 16,
                                         seed + 1),
                         ServeConfig(batch_size=2, max_new_tokens=2,
                                     prefill_chunk=8, paged_backend="cuda"))
        sc_s = dataclasses.replace(sc, num_shards=shards)
        streams[shards], st, counts = run(f"f32_{shards}", eng, sc_s)
        if shards > 1:
            require(st["shard_placements"]["adapter"] == 8,
                    f"{shards} shards: placements {st['shard_placements']}")
            require(streams[shards] == streams[1],
                    f"streams at {shards} shards differ from one pool")
        if shards == 2:
            counts2 = counts
        engines[shards] = eng
    del engines[4], trees
    torch.cuda.empty_cache()
    # prefix cache: cold then warm on the pinned pool at 2 shards.  Cold
    # makes the dispatches of the run without the cache: bitwise equal.
    # Warm re-matches every full block of each prompt on the shard that
    # sealed it.  Warm against cold is the margin rule (below), not
    # bitwise: a token that the cold run makes as a feedback row of a
    # 2048-row prefill dispatch (LoRA's wgmma plan, the prefill kernel)
    # the warm run makes in an 8-row decode dispatch (split-K plan, the
    # decode kernel)
    eng = engines[2]
    sc_p = dataclasses.replace(sc, num_shards=2, prefix_cache=True, **pinned)
    eng.release_prefix_cache()
    cold, _, _ = run("prefix_cold_2", eng, sc_p)
    warm, st_warm, _ = run("prefix_warm_2", eng, sc_p)
    eng.release_prefix_cache()
    hits = sum((len(r.prompt) - 1) // 16 * 16 for r in reqs)
    require(st_warm["prefix_pool_reused"]
            and st_warm["prefix_hit_tokens"] == hits,
            f"warm run: reused {st_warm['prefix_pool_reused']}, "
            f"{st_warm['prefix_hit_tokens']} hit tokens, not {hits}")
    require(st_warm["shard_placements"]["prefix"] == len(reqs),
            f"warm run: placements {st_warm['shard_placements']}")
    require(cold == streams[1], "cold prefix-cache streams differ from the "
            "streams without the cache")
    # hot-swap at 2 shards: client 3 re-registers after the first decode
    # round; the other clients' streams must stay those of the f32_2 run
    kernels.reset_launch_counts()
    ses = eng.session(dataclasses.replace(sc, num_shards=2), reqs)
    swapped = [[] for _ in reqs]
    swap_ms = None
    while ses.has_work:
        decodes = ses.sched.decode_dispatches
        for rid, toks, _ in ses.step():
            swapped[rid].extend(toks)
        if swap_ms is None and ses.sched.decode_dispatches > decodes:
            register_client(eng.registry, cfg, 3, device, 900, None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.registry.kernel_bank()
            torch.cuda.synchronize()
            swap_ms = (time.perf_counter() - t0) * 1e3
    st = ses.finalize()
    moved = [i for i, r in enumerate(reqs) if r.client_id == "client3"]
    untouched = [i for i in range(len(reqs)) if i not in moved]
    emit({"phase": "sharded_hot_swap", "swapped_client": "client3",
          "adapter_bank_refreshes": st["adapter_bank_refreshes"],
          "bank_concat_ms_after_swap": swap_ms,
          "untouched_equal": all(swapped[i] == streams[2][i]
                                 for i in untouched),
          "swapped_stream_moved": any(swapped[i] != streams[2][i]
                                      for i in moved),
          "launches": kernels.launch_counts()})
    require(swap_ms is not None and st["adapter_bank_refreshes"] >= 1,
            "hot-swap: the bank was never refreshed")
    require(all(swapped[i] == streams[2][i] for i in untouched),
            "hot-swap: an untouched client's stream moved")
    # the first chunk "cuda" vs "torch" through the 2-shard registry's
    # kernel view (bf16 <= 10%; fp32 activations <= 1%)
    err_bf16 = compare_first_chunk(eng, reqs, sc, "bfloat16", rel_tol=0.1,
                                   extra={"num_shards": 2})
    cfg32 = cfg.with_overrides(dtype="float32")
    compare_first_chunk(MultiTenantEngine(Model(cfg32, device), cfg32,
                                          params, eng.registry),
                        reqs, sc, "float32", rel_tol=1e-2,
                        extra={"num_shards": 2})
    # warm against cold by the margin rule (2-shard engine, bf16 error)
    m_warm = streams_by_margin(eng, reqs, sc, warm, cold, err_bf16,
                               "sharded warm vs cold")
    emit({"phase": "sharded_streams", "shards_bitwise": [2, 4],
          "err_bound": 2 * err_bf16, "warm_vs_cold_matched": m_warm,
          "warm_equals_cold": warm == cold})
    del eng, engines[2]
    torch.cuda.empty_cache()
    # int8 K/V over a ragged int8 bank, at 1 and 2 shards: capacity 16 (8
    # slots a shard at 2: buckets of 3, 3, 2 for the tenants' 4, 8, 16)
    int8 = {}
    trees = fused_trees(cfg, device, ranks=[4, 8, 16])
    for shards in (1, 2):
        eng, concat_ms[f"int8_ragged_{shards}"] = sharded_engine(
            device, params, cfg, shards, trees, capacity=16,
            ranks=[4, 8, 16], bank_dtype="int8")
        sc_i = dataclasses.replace(sc, num_shards=shards, kv_dtype="int8")
        int8[shards], st, _ = run(f"int8_ragged_{shards}", eng, sc_i)
        if shards > 1:
            require(int8[2] == int8[1], "int8 streams at 2 shards differ "
                    "from one pool")
            compare_first_chunk(eng, reqs, sc_i, "bfloat16", rel_tol=0.1,
                                extra={"num_shards": 2, "kv_dtype": "int8",
                                       "bank": "ragged int8"})
            compare_first_chunk(
                MultiTenantEngine(Model(cfg32, device), cfg32, params,
                                  eng.registry),
                reqs, dataclasses.replace(sc_i, kv_dtype="f32"), "float32",
                rel_tol=1e-2, extra={"num_shards": 2, "kv_dtype": "f32",
                                     "bank": "ragged int8"})
        del eng
        torch.cuda.empty_cache()
    del trees
    emit({"phase": "bank_concat", "ms_first_build": concat_ms,
          "ms_after_swap": swap_ms,
          "f32_bank_gb": sum(t.numel() * t.element_size() for _, t in
                             tree_leaves(engines[1].registry.bank())) / 1e9})
    return counts2, engines[1]


# ---------------------------------------------------------------------------
# phase 4c: the fixed-batch path and the single-tenant engine
# ---------------------------------------------------------------------------

def fixed_phase(eng, seed: int, prompt_len: int = 64, new_tokens: int = 16,
                cache_len: int = 128):
    """llama2-7b, 32 layers, bf16: one seeded 64-token prompt, 16 new
    tokens, cache_len 128, greedy.  ``generate_fixed`` serves 8 requests,
    one per tenant, over the fp32 bank (batched LoRA at M = 8 per step);
    ``Engine.generate`` serves 8 rows with one Eq. 7-merged adapter
    (``lora_matmul`` at M = 8).  Checks: each path's logits at the last
    prompt position "cuda" vs "torch" (bf16 <= 10%, fp32 activations <=
    1% of the largest logit), ``generate_fixed``'s streams against the
    continuous "cuda" engine's by the margin rule, the kernels' launch
    counters on their tensor-core tiles.  Returns {kernel: launches}."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core.dual_lora import merge
    from repro_torch.core.lora import init_adapters
    from repro_torch.models.api import Model
    from repro_torch.serving.engine import (Engine, MultiTenantEngine,
                                            Request, ServeConfig)
    cfg, dev = eng.cfg, eng.device
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, cfg.vocab_size, prompt_len).astype(np.int32)
    reqs = [Request(f"client{i}", prompt) for i in range(8)]
    sc = ServeConfig(batch_size=8, max_new_tokens=new_tokens,
                     cache_len=cache_len, paged_backend="cuda")
    pair = [init_adapters(cfg, seed=seed + s, device=dev, b_std=0.02)
            for s in (700, 701)]
    single = Engine(eng.model, cfg, eng.params, merge(*pair, [0.6, 0.6]))
    del pair
    steps = prompt_len + new_tokens - 1
    out, launched = {}, {}
    for name, fn, kernel in (
            ("generate_fixed", lambda: eng.generate_fixed(reqs, sc),
             "batched_lora_matmul"),
            ("engine_generate",
             lambda: single.generate(np.tile(prompt, (8, 1)), sc),
             "lora_matmul")):
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts, tiles = kernels.launch_counts(), kernels.tile_counts()
        emit({"phase": "fixed", "run": name, "rows": 8,
              "prompt_len": prompt_len, "new_tokens": new_tokens,
              "cache_len": cache_len, "steps": steps, "s": secs,
              "ms_per_step": secs / steps * 1e3,
              "tok_per_s": 8 * new_tokens / secs,
              "launches": counts, "tile_launches": tiles})
        require(tuple(res.shape) == (8, new_tokens)
                and bool(((res >= 0) & (res < cfg.vocab_size)).all()),
                f"fixed {name}: malformed output")
        require(counts[kernel] > 0, f"fixed {name}: {kernel} never launched")
        require_mma_tile(tiles, kernel, f"fixed {name}")
        out[name], launched[kernel] = res.cpu().tolist(), counts[kernel]
    # the last prompt position's logits through the fixed path's own
    # sequential prefill, "cuda" vs "torch"
    prompts = torch.as_tensor(np.tile(prompt, (8, 1)), device=dev)
    ids = torch.tensor([eng.registry.acquire(r.client_id) for r in reqs],
                       dtype=torch.int32, device=dev)
    cfg32 = cfg.with_overrides(dtype="float32")
    eng32 = MultiTenantEngine(Model(cfg32, dev), cfg32, eng.params,
                              eng.registry)
    err = {}
    for name, e, routed, dtype_name, rel in (
            ("generate_fixed", eng, True, "bfloat16", 0.1),
            ("generate_fixed", eng32, True, "float32", 1e-2),
            ("engine_generate", single, False, "bfloat16", 0.1)):
        logits = {}
        for backend in ("cuda", "torch"):
            bank = (e.bank_for(dataclasses.replace(sc, paged_backend=backend))
                    if routed else single.adapters)
            _, _, logits[backend] = e._prefill(
                e.params, bank, ids if routed else None,
                e.model.init_decode_cache(8, cache_len), prompts, backend)
        lc, lt = logits["cuda"], logits["torch"]
        e_ = float((lc - lt).abs().max())
        top = float(lt.abs().max())
        top2 = torch.topk(lt, 2, dim=-1).values
        decisive = (top2[:, 0] - top2[:, 1]) > 2 * e_
        agree = lc.argmax(-1) == lt.argmax(-1)
        emit({"phase": "fixed_compare", "run": name,
              "activations": dtype_name, "last_prompt_max_abs_logit_err": e_,
              "max_abs_logit": top, "tol": rel * top,
              "first_token_agree": int(agree.sum()), "rows": 8,
              "decisive_rows": int(decisive.sum())})
        require(bool(torch.isfinite(lc).all()), f"fixed {name}: cuda "
                "logits not finite")
        require(e_ <= rel * top, f"fixed {name} {dtype_name}: logit error "
                f"{e_} > {rel * top}")
        require(bool(agree[decisive].all()), f"fixed {name}: greedy token "
                "differs on a row whose margin exceeds the error")
        err.setdefault((name, dtype_name), e_)
    del eng32
    # against the continuous engine on the same requests: the two paths
    # attend differently (plain SDPA over the ring against the paged
    # kernels), so the rule is the margin rule, not bitwise
    csc = ServeConfig(batch_size=8, max_new_tokens=new_tokens,
                      prefill_chunk=256, block_size=16, paged_backend="cuda")
    cont = eng.generate(reqs, csc)
    matched = streams_by_margin(eng, reqs, csc, out["generate_fixed"],
                                [o.tolist() for o in cont],
                                err["generate_fixed", "bfloat16"],
                                "fixed vs continuous")
    emit({"phase": "fixed_streams", "err_bound":
          2 * err["generate_fixed", "bfloat16"],
          "fixed_vs_continuous_matched": matched})
    return launched


# ---------------------------------------------------------------------------
# phase 5: the training path (FDLoRA Algorithm 1)
# ---------------------------------------------------------------------------

def _rel(a, b) -> float:
    """||a - b|| / ||b|| in fp32."""
    import torch
    return float(torch.linalg.vector_norm((a - b).float())
                 / torch.linalg.vector_norm(b.float()).clamp(min=1e-30))


def compare_grads(vg, batch, dtype_name, loss_tol, grad_tol,
                  phase="compare_train_step", **extra):
    """One step's loss and every adapter gradient through "cuda" and
    "torch" from the same adapters and batch: ``vg(backend) -> (loss,
    metrics, grads)``.  The "torch" step must launch no kernel.  Bounds are
    relative: ``|Δloss| <= loss_tol·|loss|`` and, per adapter leaf,
    ``||Δg|| <= grad_tol·||g||``."""
    import torch
    from repro_torch import kernels
    from repro_torch.core.lora import tree_leaves
    out = {}
    for backend in ("cuda", "torch"):
        kernels.reset_launch_counts()
        loss, _, grads = vg(backend)
        torch.cuda.synchronize()
        tiles = kernels.tile_counts()
        out[backend] = (loss, dict(tree_leaves(grads)),
                        kernels.launch_counts(),
                        {k: tiles[k] for k in ("flash_attention",
                                               "lora_matmul")})
        del grads
    (lc, gc, nc, tiles), (lt, gt, nt, _) = out["cuda"], out["torch"]
    loss_err = abs(float(lc) - float(lt)) / abs(float(lt))
    grad_errs = {p: _rel(gc[p], gt[p]) for p in gt}
    worst = max(grad_errs, key=grad_errs.get)
    what = f"{extra.get('method', 'train step')} {dtype_name}"
    emit({"phase": phase, **extra, "activations": dtype_name,
          "rows": int(batch["tokens"].numel()), "loss_cuda": float(lc),
          "loss_torch": float(lt), "loss_rel_err": loss_err,
          "loss_tol": loss_tol, "grad_leaves": len(grad_errs),
          "max_grad_rel_err": grad_errs[worst], "worst_leaf": worst,
          "median_grad_rel_err": sorted(grad_errs.values())[
              len(grad_errs) // 2], "grad_tol": grad_tol,
          "launches_cuda": nc, "tiles_cuda": tiles})
    require(all(torch.isfinite(g).all() for g in gc.values()),
            f"{what}: a cuda gradient is not finite")
    require(loss_err <= loss_tol,
            f"{what}: loss rel err {loss_err} > {loss_tol}")
    require(grad_errs[worst] <= grad_tol,
            f"{what}: gradient {worst} rel err {grad_errs[worst]} > "
            f"{grad_tol}")
    require(nc["lora_matmul"] > 0 and nc["flash_attention"] > 0,
            f"{what}: the cuda step did not launch its kernels")
    want = "mma" if dtype_name == "bfloat16" else "f32"
    for name in ("flash_attention", "lora_matmul"):
        require(tiles[name][want] == nc[name],
                f"{what}: {name} tiles {tiles[name]}, not all {want}")
    require(all(n == 0 for n in nt.values()),
            f"{what}: the torch step launched a CUDA kernel")


def compare_train_step(model, cfg, params, adapters, batch, dtype_name,
                       loss_tol, grad_tol):
    """``compare_grads`` for the plain LoRA train step."""
    from repro_torch.training.train_step import lora_value_and_grad
    compare_grads(lambda backend: lora_value_and_grad(model, cfg, backend)(
        params, adapters, batch), batch, dtype_name, loss_tol, grad_tol)


def compare_fused_eval(model, cfg, params, ad_p, ad_s, batch, dtype_name,
                       tol):
    """The AdaFusion objective at w = (0.6, 0.6) through "cuda" (the
    dual-LoRA kernel merges on the chip) and "torch" (merge, then the plain
    forward): ``|Δloss| <= tol·|loss|``."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.training.train_step import make_fused_eval_fn
    w = np.asarray([0.6, 0.6], np.float32)
    losses, counts = {}, {}
    for backend in ("cuda", "torch"):
        kernels.reset_launch_counts()
        loss, _ = make_fused_eval_fn(model, cfg, backend)(params, ad_p, ad_s,
                                                          w, batch)
        losses[backend], counts[backend] = float(loss), kernels.launch_counts()
        if backend == "cuda":
            tiles = kernels.tile_counts()["dual_lora_matmul"]
    err = abs(losses["cuda"] - losses["torch"]) / abs(losses["torch"])
    emit({"phase": "compare_fused_eval", "activations": dtype_name,
          "w": w.tolist(), "loss_cuda": losses["cuda"],
          "loss_torch": losses["torch"], "loss_rel_err": err, "tol": tol,
          "launches_cuda": counts["cuda"], "dual_lora_tiles_cuda": tiles})
    require(err <= tol, f"{dtype_name} fused-eval loss rel err {err} > {tol}")
    require(counts["cuda"]["dual_lora_matmul"] > 0,
            "the cuda fused evaluation did not launch dual_lora_matmul")
    want = "mma" if dtype_name == "bfloat16" else "f32"
    require(tiles[want] == counts["cuda"]["dual_lora_matmul"],
            f"{dtype_name} fused evaluation: dual_lora_matmul tiles {tiles}, "
            f"not all {want}")
    require(all(n == 0 for n in counts["torch"].values()),
            "the torch fused evaluation launched a CUDA kernel")


# the train and baselines cells' data: 2 clients of 8 x 256-token SFT
# batches of log windows (64 examples each), and 32 held-out examples per
# client from generators of their own
TRAIN_CLIENTS, TRAIN_BATCH, TRAIN_SEQ, HELD_OUT = 2, 8, 256, 32


def train_batchers(seed: int):
    import numpy as np
    from repro_torch.data.pipeline import SFTBatcher
    from repro_torch.data.synthetic import gen_log_dataset
    from repro_torch.data.tokenizer import ByteTokenizer
    rng = np.random.default_rng(seed)
    return [SFTBatcher(gen_log_dataset(rng, 64, i), ByteTokenizer(),
                       TRAIN_SEQ, TRAIN_BATCH, seed=i)
            for i in range(TRAIN_CLIENTS)]


def held_out_examples(seed: int, n_clients: int):
    import numpy as np
    from repro_torch.data.synthetic import gen_log_dataset
    return [gen_log_dataset(np.random.default_rng(seed + 1000 + i), HELD_OUT,
                            i) for i in range(n_clients)]


def train_phase(device, seed: int, params, cfg):
    """FDLoRA on llama2-7b: the cuda/torch comparisons, then the fit through
    the kernels, FDLoRA's answer accuracy on the held-out examples,
    publish and serve, and one traced train step.  Returns the launch
    counts of the fit and the accuracy per client."""
    import math

    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core.fdlora import FDLoRAConfig, FDLoRATrainer
    from repro_torch.core.lora import init_adapters, tree_leaves
    from repro_torch.data.synthetic import answer_accuracy, gen_log_dataset
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.models.api import Model
    from repro_torch.serving.engine import (MultiTenantEngine, Request,
                                            ServeConfig)
    from repro_torch.serving.registry import AdapterRegistry
    from repro_torch.training.train_step import make_lora_train_step
    from repro_torch.training.optimizers import adamw

    model = Model(cfg, device)
    tok = ByteTokenizer()
    S, B, n_clients = TRAIN_SEQ, TRAIN_BATCH, TRAIN_CLIENTS
    batchers = train_batchers(seed)

    def dev_batch(raw, rows=None):
        return {k: torch.as_tensor(v[:rows]).to(device)
                for k, v in raw.items()}

    # 1-2: "cuda" against "torch" from the same adapters (B non-zero) and
    # the same batch.  bf16: the paths round at other places (the LoRA
    # kernels round once where the plain dense rounds twice, the attention
    # tile rounds unnormalised probabilities) through 32 layers, forward and
    # backward; the serve phase's logits differ by 3.7% of their largest
    # value for that reason alone.  A lost LoRA term, a wrong mask or a
    # wrong backward term moves a gradient by O(its size), so the bounds
    # are 2% on the loss and 25% per gradient leaf.  fp32 activations over
    # the same bf16 weights: summation order only, so 1e-3 and 1e-2.
    ad = init_adapters(cfg, seed=seed + 100, device=device, b_std=0.02)
    ad_s = init_adapters(cfg, seed=seed + 101, device=device, b_std=0.02)
    raw = batchers[0].sample()
    t0 = time.perf_counter()
    compare_train_step(model, cfg, params, ad, dev_batch(raw), "bfloat16",
                       loss_tol=2e-2, grad_tol=0.25)
    compare_fused_eval(model, cfg, params, ad, ad_s, dev_batch(raw),
                       "bfloat16", tol=2e-2)
    cfg32 = cfg.with_overrides(dtype="float32")
    model32 = Model(cfg32, device)
    # half the batch: the plain fp32 path keeps an fp32 copy of every
    # weight it multiplies for its backward (26 GB at full depth)
    compare_train_step(model32, cfg32, params, ad, dev_batch(raw, B // 2),
                       "float32", loss_tol=1e-3, grad_tol=1e-2)
    compare_fused_eval(model32, cfg32, params, ad, ad_s, dev_batch(raw),
                       "float32", tol=1e-3)
    del ad, ad_s, model32
    torch.cuda.empty_cache()
    compare_s = time.perf_counter() - t0

    # 3-4: the whole of Algorithm 1 through the kernels
    fed = FDLoRAConfig(n_clients=n_clients, stage1_steps=2, rounds=2,
                       inner_steps=2, sync_every=1, fusion_steps=1,
                       few_shot_k=8, batch_size=B, seed=seed)
    tr = FDLoRATrainer(model, cfg, fed, params, device=device)
    require(tr.paged_backend == "cuda", "the trainer did not pick 'cuda'")
    step_s = []
    inner_step = tr._step

    def timed_step(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner_step(*args)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        return out
    tr._step = timed_step
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clients = tr.stage1(batchers)
    tr.stage2(clients, batchers)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tr.stage3(clients, batchers)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = kernels.launch_counts()
    tiles = kernels.tile_counts()
    losses = [h["loss"] for h in tr.history]
    weights = [c.fusion_weights.tolist() for c in clients]
    med = float(np.median(step_s))
    emit({"phase": "train", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "dtype": cfg.dtype, "rank": cfg.lora_rank,
          "alpha": cfg.lora_alpha, "targets": list(cfg.lora_targets),
          "clients": n_clients, "batch": B, "seq": S,
          "train_steps": len(step_s),
          "fused_evals": n_clients * (1 + 8 * fed.fusion_steps),
          "step_s": step_s, "median_step_s": med,
          "train_tokens_per_s": B * S / med,
          "stage1_2_s": t1 - t0, "stage3_s": t2 - t1,
          "round_losses": losses, "fusion_weights": weights,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": counts, "tile_launches": tiles,
          "compare_s": compare_s})
    require(len(step_s) == 12, f"{len(step_s)} train steps, not 12")
    require(all(math.isfinite(x) for x in losses), "a round loss is not finite")
    require(all(math.isfinite(x) for w in weights for x in w),
            "a fusion weight is not finite")
    require(all(bool(torch.isfinite(t).all())
                for c in clients for _, t in tree_leaves(c.personalized)),
            "a personalized adapter is not finite")
    for name in kernels.TRAINING:
        require(counts[name] > 0,
                f"kernel {name} was never launched on the training path")
    for name in ("flash_attention", "lora_matmul", "dual_lora_matmul"):
        require_mma_tile(tiles, name, "train")
    # FDLoRA's fused adapters on the held-out examples, beside which the
    # baselines phase reads its methods'
    t0 = time.perf_counter()
    accuracy = [answer_accuracy(model, cfg, params, tr.fused_adapters(c),
                                ex, tok, S, tr.scale)
                for c, ex in zip(clients, held_out_examples(seed, n_clients))]
    emit({"phase": "train_accuracy", "method": "fdlora",
          "held_out_per_client": HELD_OUT, "max_len": S,
          "answer_accuracy": accuracy, "s": time.perf_counter() - t0})

    # 5: publish into the serving slice and generate from it
    registry = AdapterRegistry(cfg, capacity=n_clients, device=device)
    slots = tr.publish(registry, clients)
    eng = MultiTenantEngine(model, cfg, params, registry)
    kernels.reset_launch_counts()
    prompts = [gen_log_dataset(np.random.default_rng(seed + 7), 1, i)[0]
               for i in range(n_clients)]
    reqs = [Request(f"client{i}", np.asarray(tok.encode(ex.prompt), np.int32))
            for i, ex in enumerate(prompts)]
    outs = eng.generate(reqs, ServeConfig(batch_size=n_clients,
                                          max_new_tokens=8, prefill_chunk=64,
                                          block_size=16, paged_backend="cuda"))
    emit({"phase": "publish_and_serve", "slots": slots,
          "versions": {c: registry.version(c) for c in slots},
          "prompt_lens": [len(r.prompt) for r in reqs],
          "tokens": [[int(t) for t in o] for o in outs]})
    require(all(len(o) == 8 and all(0 <= t < cfg.vocab_size for t in o)
                for o in outs), "a stream from the published adapters is "
            "malformed")
    require_mma_tile(kernels.tile_counts(), "batched_lora_matmul",
                     "publish_and_serve")
    del eng, registry

    # one traced train step
    step = make_lora_train_step(model, cfg, adamw(), paged_backend="cuda")
    ad = clients[0].personalized
    st = adamw().init(ad)
    batch = dev_batch(batchers[0].sample())
    wall_ms, fam = traced(lambda: step(params, ad, st, batch),
                          TRAIN_FAMILIES,
                          "other device work (norms, rope, softmax, "
                          "elementwise, optimizer)")
    emit(_profile_line(fam, wall_ms, phase="profile_train_step",
                       rows=B * S))
    # one traced fused evaluation, stage 3's unit of work, as the trainer
    # runs it (client 0's personalized adapter and the global one)
    wall_ms, fam = traced(lambda: tr.fused_eval_loss(
        clients[0], [0.6, 0.6], batchers[0].sample()), FUSED_EVAL_FAMILIES,
        "other device work (norms, rope, softmax, elementwise, lm_head, "
        "loss, copies)")
    dual = sum(v for k, v in fam.items() if k.startswith("dual_lora_matmul"))
    emit(_profile_line(fam, wall_ms, phase="profile_fused_eval", rows=B * S,
                       dual_lora_matmul_ms=dual,
                       dual_lora_matmul_share_of_busy=dual / max(
                           sum(fam.values()), 1e-30)))
    return counts, accuracy


# ---------------------------------------------------------------------------
# phase 5b: the federated baselines, answer_accuracy and the client-stacked
# round step
# ---------------------------------------------------------------------------

# the paper's comparison, cut from 5 clients x 30 rounds to the train cell's
# 2 clients, 2 rounds of one local step each
BASELINE_FED = dict(n_clients=TRAIN_CLIENTS, rounds=2, local_steps=1)


def _finite(tree) -> bool:
    import torch
    from repro_torch.core.lora import tree_leaves
    return all(bool(torch.isfinite(t).all()) for _, t in tree_leaves(tree))


def compare_baseline_steps(model, cfg, params, batch, dtype_name, loss_tol,
                           grad_tol, seed, rows):
    """One step's loss and gradients of FedProx, FedRoD and FedKD through
    "cuda" and "torch" (``compare_grads``) from the same adapters (B
    non-zero) and batch, its first ``rows[method]`` rows: FedProx a rank-r
    adapter with a rank-r global one in its prox term, FedRoD a rank-r
    generic and personal pair (its second forward at rank 2r), FedKD a
    rank-r teacher and a rank-r/2 student."""
    import torch
    from repro_torch.core.lora import init_adapters
    from repro_torch.federated.baselines import BASELINES, FedConfig
    from repro_torch.training.train_step import value_and_grad
    r = cfg.lora_rank
    fed = FedConfig(**BASELINE_FED, seed=seed)
    for k, (name, ranks) in enumerate((("fedprox", (r, r)),
                                       ("fedrod", (r, r)),
                                       ("fedkd", (r, max(2, r // 2))))):
        first, second = (init_adapters(cfg, rank=rk, seed=seed + 110 + 2 * k
                                       + j, device=model.device, b_std=0.02)
                         for j, rk in enumerate(ranks))
        trees, extra = ((first, (second,)) if name == "fedprox"
                        else ((first, second), ()))
        b = {key: v[:rows[name]] for key, v in batch.items()}

        def vg(backend):
            method = BASELINES[name](model, cfg, fed, params,
                                     device=model.device,
                                     paged_backend=backend)
            return value_and_grad(method.loss_fn())(trees, params, b, *extra)
        compare_grads(vg, b, dtype_name, loss_tol, grad_tol,
                      phase="compare_baseline_step", method=name,
                      ranks=list(ranks))


def compare_answer_accuracy(model, cfg, params, adapters, examples, tok,
                            max_len, scale):
    """``answer_accuracy`` through "cuda" and "torch" on the same adapters
    and examples: the greedy answer byte must agree on every example whose
    top-2 margin at the answer position ("torch" logits) is at least twice
    the largest logit difference there (``serve_options``' margin rule), so
    the accuracies differ by at most the examples under it."""
    import torch
    from repro_torch import kernels
    from repro_torch.data.synthetic import answer_accuracy, answer_logits
    from repro_torch.models.api import Model
    model_t = Model(cfg.with_overrides(paged_backend="torch"), model.device)
    out = {}
    for backend, m in (("cuda", model), ("torch", model_t)):
        kernels.reset_launch_counts()
        logits = answer_logits(m, params, adapters, examples, tok, max_len,
                               scale)
        acc = answer_accuracy(m, cfg, params, adapters, examples, tok,
                              max_len, scale)
        torch.cuda.synchronize()
        out[backend] = (logits, acc, kernels.launch_counts(),
                        kernels.tile_counts())
    (lc, acc_c, nc, tiles), (lt, acc_t, nt, _) = out["cuda"], out["torch"]
    err = float((lc - lt).abs().max())
    top2 = torch.topk(lt, 2, dim=-1).values
    close = (top2[:, 0] - top2[:, 1]) < 2 * err
    differ = lc.argmax(-1) != lt.argmax(-1)
    emit({"phase": "compare_answer_accuracy", "examples": len(examples),
          "max_len": max_len, "accuracy_cuda": acc_c, "accuracy_torch": acc_t,
          "max_abs_logit_err": err, "max_abs_logit": float(lt.abs().max()),
          "under_margin": int(close.sum()), "picks_differ": int(differ.sum()),
          "launches_cuda": {k: nc[k] for k in ("lora_matmul",
                                               "flash_attention")}})
    require(not bool((differ & ~close).any()),
            f"answer_accuracy: {int((differ & ~close).sum())} examples pick "
            f"another answer byte through cuda though their margin is at "
            f"least 2 x {err}")
    require(abs(acc_c - acc_t) * len(examples) <= int(close.sum()) + 1e-6,
            f"answer_accuracy cuda {acc_c} vs torch {acc_t}")
    for name in ("lora_matmul", "flash_attention"):
        require_mma_tile(tiles, name, "answer_accuracy")
    require(all(n == 0 for n in nt.values()),
            "the torch answer_accuracy launched a CUDA kernel")


def round_step_check(model, cfg, params, batchers, seed, K: int = 2):
    """One ``make_fdlora_round_step`` round over the clients stacked on a
    leading axis (K inner steps each, the paper's Nesterov outer step at
    FDLoRAConfig's defaults), with ``compress_outer`` "none" and "bf16"
    from the same θ_s (B non-zero) and batches, ``sync_personalized`` on so
    that each run's θ_i come back.

    The bound on the bf16 run: each client's pseudo-gradient d_i = θ_s −
    θ_i rounds to bf16 (8 significant bits: relative error ≤ 2^-8), and
    so does their mean (another 2^-8 of a value ≤ (1 + 2^-8)·max_i |d_i|),
    so the mean is off by at most 2^-7·(1 + 2^-9)·max_i |d_i|; the first
    Nesterov step (velocity from zero) moves θ_s by lr·(1 + momentum) times
    it.  So, elementwise, |θ'_bf16 − (θ_s − lr·(1 + μ)·mean_i d_i)| ≤
    lr·(1 + μ)·2^-7·(1 + 2^-8)·max_i |d_i| plus two fp32 ulps of θ' for
    the outer step's own rounding (the "none" run is held to those two
    ulps alone)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core.fdlora import FDLoRAConfig
    from repro_torch.core.lora import init_adapters, tree_leaves
    from repro_torch.core.outer_opt import make_outer_optimizer
    from repro_torch.federated.distributed import (make_fdlora_round_step,
                                                   stack_clients)
    from repro_torch.training.optimizers import adamw
    fc = FDLoRAConfig()
    inner = adamw(lr=fc.inner_lr, weight_decay=fc.inner_weight_decay)
    outer = make_outer_optimizer(fc.outer_kind, fc.outer_lr,
                                 fc.outer_momentum)
    step_lr = fc.outer_lr * (1 + fc.outer_momentum)
    theta = init_adapters(cfg, seed=seed + 120, device=model.device,
                          b_std=0.02)
    samples = [[b.sample() for _ in range(K)] for b in batchers]
    batches = {key: torch.as_tensor(np.stack([np.stack([s[key] for s in row])
                                              for row in samples])
                                    ).to(model.device)
               for key in ("tokens", "loss_mask")}
    runs = {}
    for compress in ("none", "bf16"):
        state = {"inner_opt": stack_clients([inner.init(theta)]
                                            * len(batchers)),
                 "outer_opt": outer.init(theta)}
        rs = make_fdlora_round_step(model, cfg, inner, outer, K,
                                    sync_personalized=True,
                                    compress_outer=compress)
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, st, loss = rs(params, theta, state, batches)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts, tiles = kernels.launch_counts(), kernels.tile_counts()
        worst, moved, at = 0.0, 0, {}
        for (path, prev), (_, got), (_, ti) in zip(
                tree_leaves(theta), tree_leaves(new),
                tree_leaves(st["personalized"])):
            d = prev[None] - ti
            upd = step_lr * (prev - ti.mean(dim=0))
            want = prev - upd
            # two ulps of θ' and four of the update (its own roundings,
            # which alone remain where θ_s and the update cancel)
            bnd = (2.0 ** -22 * torch.maximum(got.abs(), want.abs())
                   + 2.0 ** -21 * upd.abs())
            if compress == "bf16":
                bnd = bnd + (step_lr * 2.0 ** -7 * (1 + 2.0 ** -8)
                             * d.abs().amax(dim=0))
            ratio = (got - want).abs() / bnd.clamp(min=1e-30)
            i = int(ratio.argmax())
            if float(ratio.reshape(-1)[i]) > worst:
                worst = float(ratio.reshape(-1)[i])
                at = {"leaf": path, **{k: float(t.reshape(-1)[i]) for k, t in
                                       (("theta_s", prev), ("got", got),
                                        ("want", want), ("update", upd))}}
            moved += int((got != want).sum())
        runs[compress] = st["personalized"]
        emit({"phase": "round_step", "compress_outer": compress,
              "clients": len(batchers), "inner_steps": K,
              "batch": list(batches["tokens"].shape[2:]),
              "outer": [fc.outer_kind, fc.outer_lr, fc.outer_momentum],
              "s_per_round": secs,
              "train_tokens_per_s": batches["tokens"].numel() / secs,
              "loss": float(loss), "max_err_over_bound": worst,
              "worst_element": at, "elements_off_the_fp32_step": moved,
              "launches": {k: counts[k] for k in ("lora_matmul",
                                                  "flash_attention")}})
        require(bool(torch.isfinite(loss)) and _finite(new),
                f"round step ({compress}): θ_s' or the loss is not finite")
        require(worst <= 1.0, f"round step ({compress}): θ_s' off the "
                f"outer step from its own θ_i by {worst} x the bound")
        for name in ("lora_matmul", "flash_attention"):
            require_mma_tile(tiles, name, f"round step ({compress})")
        del new, st, state
    same = all(torch.equal(a, b) for (_, a), (_, b) in
               zip(tree_leaves(runs["none"]), tree_leaves(runs["bf16"])))
    emit({"phase": "round_step_theta_i", "bitwise_equal_across_runs": same})


def baselines_phase(device, seed: int, params, cfg, fdlora_accuracy):
    """The six baselines and Local on llama2-7b through the kernels at the
    train cell's data (``BASELINE_FED``), each with s per round, train
    tokens/s, peak memory, bytes communicated, its kernel launches by tile
    and its adapters' answer accuracy on the held-out examples beside
    FDLoRA's; "cuda" against "torch" on one step of FedProx, FedRoD and
    FedKD and on ``answer_accuracy``; the client-stacked round step; one
    traced FedRoD step."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core.lora import init_adapters, lora_scale, tree_leaves
    from repro_torch.data.synthetic import answer_accuracy
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.federated.baselines import BASELINES, FedConfig
    from repro_torch.models.api import Model

    model = Model(cfg, device)
    tok = ByteTokenizer()
    S, B = TRAIN_SEQ, TRAIN_BATCH
    held = held_out_examples(seed, TRAIN_CLIENTS)
    raw = train_batchers(seed)[0].sample()
    batch = {k: torch.as_tensor(v).to(device) for k, v in raw.items()}
    t0 = time.perf_counter()
    # 1: the new loss terms, "cuda" against "torch", at the train phase's
    # bounds; fp32 activations at fewer rows: the plain fp32 path keeps an
    # fp32 copy of every weight it multiplies for its backward (26 GB at
    # full depth), once per forward, and FedRoD and FedKD run two
    compare_baseline_steps(model, cfg, params, batch, "bfloat16", 2e-2, 0.25,
                           seed, rows={"fedprox": B, "fedrod": B,
                                       "fedkd": B})
    cfg32 = cfg.with_overrides(dtype="float32")
    compare_baseline_steps(Model(cfg32, device), cfg32, params, batch,
                           "float32", 1e-3, 1e-2, seed,
                           rows={"fedprox": B // 2, "fedrod": 1, "fedkd": 1})
    compare_s = time.perf_counter() - t0

    # 2: each method's fit through the kernels
    fed = FedConfig(**BASELINE_FED, seed=seed)
    steps = fed.rounds * fed.n_clients * fed.local_steps
    comm, kept = {}, None
    for name, cls in BASELINES.items():
        method = cls(model, cfg, fed, params, device=device)
        require(method.paged_backend == "cuda",
                f"{name} did not pick 'cuda'")
        batchers = train_batchers(seed)
        # each step starts by moving its batch to the card: the times
        # between those moves (synchronised) are the steps' (with a
        # round's aggregation in the step after it)
        marks, to_dev = [], method._dev

        def marked(raw, to_dev=to_dev, marks=marks):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            return to_dev(raw)
        method._dev = marked
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ads = method.fit(batchers)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        step_s = np.diff(marks + [t1 + secs]).tolist()
        counts, tiles = kernels.launch_counts(), kernels.tile_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        t2 = time.perf_counter()
        acc = [answer_accuracy(model, cfg, params, ad, ex, tok, S,
                               method.scale) for ad, ex in zip(ads, held)]
        ranks = sorted({t.shape[1] for ad in ads for p, t in tree_leaves(ad)
                        if p.endswith("['a']")})
        comm[name] = method.comm_bytes
        emit({"phase": "baselines", "method": name, **BASELINE_FED,
              "cut": "5 clients x 30 rounds (the paper's) cut to 2 x 2",
              "batch": B, "seq": S, "train_steps": steps,
              "s": secs, "s_per_round": secs / fed.rounds,
              "step_s": step_s,
              "train_tokens_per_s": steps * B * S / secs,
              "peak_memory_gb": peak, "comm_bytes": method.comm_bytes,
              "returned_ranks": ranks,
              "launches": {k: counts[k] for k in ("lora_matmul",
                                                  "flash_attention")},
              "tiles": {k: tiles[k] for k in ("lora_matmul",
                                              "flash_attention")},
              "answer_accuracy": acc,
              "fdlora_answer_accuracy": fdlora_accuracy,
              "held_out_per_client": HELD_OUT,
              "accuracy_s": time.perf_counter() - t2})
        require(len(ads) == fed.n_clients and all(_finite(a) for a in ads),
                f"{name}: a returned adapter is not finite")
        require((method.comm_bytes == 0) == (name == "local"),
                f"{name}: comm_bytes {method.comm_bytes}")
        for k in ("lora_matmul", "flash_attention"):
            require_mma_tile(tiles, k, name)
        require(all(counts[k] == 0 for k in counts
                    if k not in ("lora_matmul", "flash_attention")),
                f"{name} launched a kernel off the training path: {counts}")
        if name == "fedavg":
            require(all(torch.equal(a, b) for (_, a), (_, b) in
                        zip(tree_leaves(ads[0]), tree_leaves(ads[1]))),
                    "FedAvg's clients differ")
            kept = ads[0]
        del ads, method
    require(comm["fedkd"] < comm["fedavg"],
            f"FedKD sent {comm['fedkd']} bytes, not fewer than FedAvg's "
            f"{comm['fedavg']}")

    # 3: answer_accuracy "cuda" against "torch" on FedAvg's adapters
    compare_answer_accuracy(model, cfg, params, kept, held[0], tok, S,
                            lora_scale(cfg))
    del kept

    # 4: the client-stacked round step
    round_step_check(model, cfg, params, train_batchers(seed), seed)

    # 5: one traced FedRoD step (two forwards, the second at rank 2r)
    rod = BASELINES["fedrod"](model, cfg, fed, params, device=device)
    step = rod._make_step(rod.loss_fn())
    pair = tuple(init_adapters(cfg, seed=seed + 130 + j, device=device,
                               b_std=0.02) for j in range(2))
    st = rod.opt.init(pair)
    wall_ms, fam = traced(lambda: step(pair, st, batch), TRAIN_FAMILIES,
                          "other device work (norms, rope, softmax, "
                          "elementwise, optimizer)")
    emit(_profile_line(fam, wall_ms, phase="profile_baseline_step",
                       method="fedrod", rows=B * S, compare_s=compare_s))


# ---------------------------------------------------------------------------
# phase 6: the rest of the dense family at full width and depth
# ---------------------------------------------------------------------------

# why each arch is here: gemma-2b runs head dim 256 (one kv head, a 256,000
# token tied vocabulary); olmo-1b MHA with a non-parametric LayerNorm and
# tied embeddings; yi-6b GQA 8 over 32 layers; starcoder2-15b G 12, a
# gate-less GELU MLP (6 LoRA targets), LayerNorm with bias and a 4,096
# token sliding window
DENSE_FAMILY = ("gemma-2b", "olmo-1b", "yi-6b", "starcoder2-15b")
DENSE_TENANTS = 4
DENSE_REQUESTS = 4          # and one of LONG_PROMPT tokens under a window
LONG_PROMPT = 4608


def dense_requests(arch) -> int:
    """The requests phase dense_family serves ``arch`` at once."""
    from repro_torch.configs import get_config
    return DENSE_REQUESTS + bool(get_config(arch).sliding_window)


def projection_shapes(arch):
    """The (K, N) of ``arch``'s projections that run batched_lora_matmul,
    sorted: every LoRA target but an MoE router (whose adapter takes the
    plain lora_delta)."""
    from repro_torch.configs import get_config
    from repro_torch.core.lora import block_target_shapes
    cfg = get_config(arch)
    return sorted({kn for part in block_target_shapes(
        cfg, cfg.layer_entry(0)).values()
        for name, kn in part.items() if name != "router"})


def window_chunk_check(eng, req, sc, dtype_name, rel_tol):
    """``req``'s prompt (longer than the window) fed in chunks through
    "cuda" up to its last chunk; then the last chunk, where every query's
    window starts past position 0, through "cuda" and "torch" on copies
    of the same pools: ``compare_first_chunk``'s rule over every position
    of the chunk (max logit error within ``rel_tol`` of the largest logit;
    the greedy token equal wherever the top-2 margin exceeds twice it).
    The same chunk through "torch" with the window off must miss "torch"
    with it by more than that limit, so the check sees the window."""
    import copy
    import dataclasses

    import torch
    from repro_torch import kernels
    from repro_torch.models.api import Model
    cfg = eng.model.cfg
    no_window = copy.copy(eng)
    no_window.model = Model(cfg.with_overrides(sliding_window=0), eng.device)
    T, n = sc.prefill_chunk, len(req.prompt)
    last0 = (n - 1) // T * T
    require(last0 >= cfg.sliding_window > 0,
            f"the last chunk (from {last0}) does not pass the window "
            f"{cfg.sliding_window}")
    kv, cache = _fresh_pool(eng, sc, n)
    kv.admit(0)
    head = dataclasses.replace(req, prompt=req.prompt[:last0])
    _, cache = feed_chunks(eng, kv, cache, 0, head, sc, "cuda")
    out = {}
    for name, e, backend in (("cuda", eng, "cuda"), ("torch", eng, "torch"),
                             ("no_window", no_window, "torch")):
        kernels.reset_launch_counts()
        pools = {"layers": [{k: t.clone() for k, t in layer.items()}
                            for layer in cache["layers"]]}
        (pos, logits), = feed_chunks(e, copy.deepcopy(kv), pools, 0, req,
                                     sc, backend)[0]
        out[name] = (logits, kernels.launch_counts())
        del pools
    (lc, nc), (lt, nt), (ln, nn) = out["cuda"], out["torch"], out["no_window"]
    err = float((lc - lt).abs().max())
    window_effect = float((ln - lt).abs().max())
    top = float(lt.abs().max())
    top2 = torch.topk(lt, 2, dim=-1).values
    decisive = (top2[:, 0] - top2[:, 1]) > 2 * err
    agree = lc.argmax(-1) == lt.argmax(-1)
    emit({"phase": "window_chunk", "arch": cfg.name, "activations": dtype_name,
          "window": cfg.sliding_window, "prompt_len": n,
          "chunk_first_position": pos, "positions": int(lc.shape[0]),
          "max_abs_logit_err": err, "max_abs_logit": top,
          "tol": rel_tol * top, "decisive_positions": int(decisive.sum()),
          "greedy_agree": int(agree.sum()),
          "no_window_max_abs_logit_diff": window_effect,
          "launches_cuda": nc})
    require(bool(torch.isfinite(lc).all()), "window chunk: cuda logits not "
            "finite")
    require(err <= rel_tol * top, f"{cfg.name} {dtype_name} window chunk: "
            f"logit error {err} > {rel_tol * top}")
    require(bool(agree[decisive].all()), f"{cfg.name} window chunk: a greedy "
            "token differs where the margin exceeds twice the error")
    require(window_effect > rel_tol * top, f"{cfg.name} {dtype_name} window "
            f"chunk: without the window the logits move {window_effect}, "
            f"not past the limit {rel_tol * top}")
    require(nc["paged_prefill_attention"] > 0
            and all(v == 0 for v in (*nt.values(), *nn.values())),
            f"window chunk launches: cuda {nc}, torch {nt}, {nn}")


def dense_family_phase(device, seed: int, T: int = 256,
                       tenants: int = DENSE_TENANTS, rank: int = 16,
                       new_tokens: int = 16):
    """Each of ``DENSE_FAMILY`` at its published width and depth, bf16,
    seeded weights, ``tenants`` rank-16 fused adapters: 4 requests
    (prompts from the seed in [128, 1024]; starcoder2-15b one more of
    4,608 tokens), greedy, through "cuda" with overlap on and off (streams
    bitwise equal, every serving kernel launched, prefill attention and
    batched LoRA on their tensor-core tiles), the first chunk against
    "torch" (bf16 <= 10%, fp32 activations <= 1%); gemma-2b also a train
    step against "torch" (flash attention at head dim 256), starcoder2-15b
    its long prompt's last chunk against "torch" with the window binding.
    Returns {arch: launch counts of its overlapped run}."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.lora import init_adapters
    from repro_torch.data.pipeline import SFTBatcher
    from repro_torch.data.synthetic import gen_log_dataset
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.launch.serve import build_engine, ragged_requests
    from repro_torch.models.api import Model
    from repro_torch.serving.engine import (MultiTenantEngine, Request,
                                            ServeConfig)
    counts = {}
    for arch in DENSE_FAMILY:
        cfg = get_config(arch).with_overrides(lora_rank=rank)
        t0 = time.perf_counter()
        eng = build_engine(cfg, tenants, device, seed, rank=rank)
        torch.cuda.synchronize()
        emit({"phase": "model", "arch": cfg.name, "n_layers": cfg.n_layers,
              "d_model": cfg.d_model, "n_heads": cfg.n_heads,
              "n_kv_heads": cfg.n_kv_heads,
              "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
              "vocab_size": cfg.vocab_size, "mlp_type": cfg.mlp_type,
              "norm_type": cfg.norm_type,
              "sliding_window": cfg.sliding_window,
              "params": cfg.count_params(), "dtype": cfg.dtype,
              "tenants": tenants, "rank": rank,
              "init_s": time.perf_counter() - t0,
              "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9})
        reqs = ragged_requests(DENSE_REQUESTS, tenants, cfg.vocab_size, 128,
                               1024, seed)
        long_req = None
        if cfg.sliding_window:
            rng = np.random.default_rng(seed + 3)
            long_req = Request("client0", rng.integers(
                0, cfg.vocab_size, LONG_PROMPT).astype(np.int32))
        served = reqs + ([long_req] if long_req is not None else [])
        require(len(served) == dense_requests(arch),
                f"{arch}: {len(served)} requests, the kernel rows assume "
                f"{dense_requests(arch)}")
        sc = ServeConfig(batch_size=len(served), max_new_tokens=new_tokens,
                         prefill_chunk=T, block_size=16, paged_backend="cuda")
        eng.generate(ragged_requests(2, tenants, cfg.vocab_size, 8, 16,
                                     seed + 1),
                     ServeConfig(batch_size=2, max_new_tokens=2,
                                 prefill_chunk=8, paged_backend="cuda"))
        streams = {}
        for overlap in (True, False):
            sc.overlap = overlap
            kernels.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            outs, ttft, dec_s, dec_tok, total_s = timed_generate(eng, served,
                                                                 sc)
            launches = kernels.launch_counts()
            tiles = kernels.tile_counts()
            st = eng.last_stats
            emit({"phase": "serve", "arch": cfg.name, "backend": "cuda",
                  "overlap": overlap, "requests": len(served),
                  "prompt_lens": [len(r.prompt) for r in served],
                  "new_tokens": new_tokens, "prefill_chunk": T,
                  "tokens": sum(len(o) for o in outs),
                  "ttft_ms_p50": float(np.percentile(ttft, 50)) * 1e3,
                  "ttft_ms_max": max(ttft) * 1e3,
                  "decode_tokens": dec_tok, "decode_s": dec_s,
                  "decode_tok_per_s": dec_tok / dec_s if dec_s > 0 else None,
                  "total_s": total_s,
                  "prefill_dispatches": st["prefill_dispatches"],
                  "decode_dispatches": st["decode_dispatches"],
                  "launches": launches, "tile_launches": tiles,
                  "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
            for o in outs:
                require(len(o) == new_tokens
                        and all(0 <= t < cfg.vocab_size for t in o),
                        f"{arch}: a stream is malformed")
            for name in kernels.SERVING:
                require(launches[name] > 0, f"{arch}: kernel {name} was "
                        "never launched on the serving path")
            for name in ("paged_prefill_attention", "batched_lora_matmul"):
                require_mma_tile(tiles, name, f"{arch} overlap={overlap}")
            streams[overlap] = outs
            if overlap:
                counts[arch] = launches
        require(streams[True] == streams[False],
                f"{arch}: streams with overlap on and off differ")
        # one traced run (overlap on): device time by kernel family, idle
        wall_ms, fam = traced(
            lambda: eng.generate(served, dataclasses.replace(sc,
                                                             overlap=True)),
            KERNEL_FAMILIES, "other device work (torch: lm_head, norms, "
            "rope, scatter, sampling, copies)")
        emit(_profile_line(fam, wall_ms, phase="profile_dense_family",
                           arch=cfg.name, requests=len(served),
                           new_tokens=new_tokens, **_decode_share(fam)))
        compare_first_chunk(eng, reqs, sc, "bfloat16", rel_tol=0.1,
                            extra={"arch": cfg.name})
        cfg32 = eng.cfg.with_overrides(dtype="float32")
        eng32 = MultiTenantEngine(Model(cfg32, device), cfg32, eng.params,
                                  eng.registry)
        compare_first_chunk(eng32, reqs, sc, "float32", rel_tol=1e-2,
                            extra={"arch": cfg.name})
        if long_req is not None:
            window_chunk_check(eng, long_req, sc, "bfloat16", 0.1)
            window_chunk_check(eng32, long_req, sc, "float32", 1e-2)
        del eng32
        if arch == "gemma-2b":
            # one client's SFT batch through a train step, "cuda" against
            # "torch", at the train phase's bounds
            tok = ByteTokenizer()
            raw = SFTBatcher(gen_log_dataset(np.random.default_rng(seed), 64,
                                             0), tok, 256, 8,
                             seed=0).sample()
            batch = {k: torch.as_tensor(v).to(device) for k, v in raw.items()}
            ad = init_adapters(eng.cfg, seed=seed + 100, device=device,
                               b_std=0.02)
            compare_train_step(eng.model, eng.cfg, eng.params, ad, batch,
                               "bfloat16", loss_tol=2e-2, grad_tol=0.25)
            compare_train_step(Model(cfg32, device), cfg32, eng.params, ad,
                               {k: v[:4] for k, v in batch.items()},
                               "float32", loss_tol=1e-3, grad_tol=1e-2)
            del ad, batch
        del eng
        torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 7: the MoE family
# ---------------------------------------------------------------------------

# (arch, layers served): dbrx-132b's published width at 8 of its 40 layers
# (54.6 GB of bf16 weights), kimi-k2-1t-a32b's at 1 of its 61 (38.5 GB);
# the whole depth of either does not fit one 80 GB card
MOE_FAMILY = (("dbrx-132b", 8), ("kimi-k2-1t-a32b", 1))
MOE_TENANTS = 4
MOE_REQUESTS = 4


class RoutingLog:
    """Wraps ``repro_torch.models.moe._top_k_routing`` and ``dispatch``
    for the first-chunk checks: every routing call's router logits and
    own top-k ids go to ``log`` and every dispatch's count of dropped
    copies to ``dropped``, in call (layer) order; with ``pinned`` (one ids
    tensor per call) each call routes to those ids instead, weighted by
    its own probabilities there, renormalised as top-k weights are.
    Nothing in the package changes: the wrappers are installed and removed
    around one dispatch."""

    def __init__(self, pinned=None):
        self.pinned = pinned
        self.log, self.dropped = [], []

    def __enter__(self):
        from repro_torch.models import moe
        self._orig, self._dispatch = moe._top_k_routing, moe.dispatch
        moe._top_k_routing, moe.dispatch = self, self._count_dispatch
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._top_k_routing, moe.dispatch = self._orig, self._dispatch

    def _count_dispatch(self, ids, E, cap):
        dest, keep = self._dispatch(ids, E, cap)
        self.dropped.append((~keep).sum())
        return dest, keep

    def __call__(self, logits, k):
        import torch
        w, ids, aux = self._orig(logits, k)
        self.log.append((logits.detach().float().clone(), ids.clone()))
        if self.pinned is not None:
            ids = self.pinned[len(self.log) - 1]
            w = torch.softmax(logits.float(), dim=-1).gather(1, ids)
            w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        return w, ids, aux


def _flips(ids_a, ids_b):
    """(token, layer) pairs whose expert sets differ, per layer: a bool
    (T,) each."""
    import torch
    return [(torch.sort(a, -1).values != torch.sort(b, -1).values).any(-1)
            for a, b in zip(ids_a, ids_b)]


def moe_first_chunk(eng, reqs, sc, dtype_name, rel_tol, repeat=False):
    """The first prefill chunk through "cuda", and through "torch" with
    each layer's expert ids pinned to the "cuda" run's: the pinned logits
    held to ``compare_first_chunk``'s rule (max error within ``rel_tol``
    of the largest logit, the greedy token equal wherever the top-2
    margin exceeds twice it), the dropped copies equal per layer.  A
    (token, layer) whose top-k set on the pinned "torch" run differs from
    "cuda"'s is a flip; each must be one the rounding can make: its k-th
    vs (k+1)-th router-logit gap at most twice that layer's router-logit
    error "cuda" vs pinned "torch".  The unpinned "torch" chunk is
    reported (its error and its flips).  ``repeat``: "cuda" twice,
    bitwise equal.  Returns the emitted line."""
    import torch
    from repro_torch import kernels
    cfg = eng.cfg
    k = cfg.n_experts_per_tok
    kernels.reset_launch_counts()
    with RoutingLog() as rc:
        lc, n_new = first_chunk_logits(eng, reqs, sc, "cuda")
    launches, tiles = kernels.launch_counts(), kernels.tile_counts()
    if repeat:
        with RoutingLog() as rc2:
            lc2, _ = first_chunk_logits(eng, reqs, sc, "cuda")
        require(torch.equal(lc, lc2) and all(
            torch.equal(a[1], b[1]) for a, b in zip(rc.log, rc2.log)),
            f"{cfg.name}: two cuda runs of the first chunk differ")
        del lc2, rc2
    ids_c = [ids for _, ids in rc.log]
    kernels.reset_launch_counts()
    with RoutingLog(pinned=ids_c) as rt:
        lt, _ = first_chunk_logits(eng, reqs, sc, "torch")
    with RoutingLog() as rf:
        lf, _ = first_chunk_logits(eng, reqs, sc, "torch")
    torch_launches = kernels.launch_counts()
    require(len(rc.log) == len(rt.log) == cfg.n_layers,
            f"{cfg.name}: {len(rc.log)} routed layers, not {cfg.n_layers}")
    valid = (torch.arange(lc.shape[1], device=lc.device)[None, :]
             < n_new.to(lc.device)[:, None])
    err = float((lc - lt).abs()[valid].max())
    err_free = float((lc - lf).abs()[valid].max())
    scale = float(lt.abs()[valid].max())
    tol = rel_tol * scale
    rows = torch.arange(lc.shape[0], device=lc.device)
    last = n_new.to(lc.device).long() - 1
    top2 = torch.topk(lt[rows, last], 2, dim=-1).values
    decisive = (top2[:, 0] - top2[:, 1]) > 2 * err
    agree = lc[rows, last].argmax(-1) == lt[rows, last].argmax(-1)
    router_err = [float((a[0] - b[0]).abs().max())
                  for a, b in zip(rc.log, rt.log)]
    flips = _flips(ids_c, [ids for _, ids in rt.log])
    worst_gap = []                       # per layer: largest flipped gap
    for (logits_t, _), flip, e in zip(rt.log, flips, router_err):
        top = torch.topk(logits_t, k + 1, dim=-1).values
        gap = (top[:, k - 1] - top[:, k])[flip]
        worst_gap.append(float(gap.max()) if gap.numel() else None)
        require(worst_gap[-1] is None or worst_gap[-1] <= 2 * e,
                f"{cfg.name} {dtype_name}: a routing flip with router-logit "
                f"gap {worst_gap[-1]} > 2 x the router error {e}")
    free_flips = _flips(ids_c, [ids for _, ids in rf.log])
    dropped_c = [int(n) for n in rc.dropped]
    dropped_t = [int(n) for n in rt.dropped]
    line = {"phase": "moe_compare", "arch": cfg.name,
            "activations": dtype_name,
            "tokens": int(lc.shape[0] * lc.shape[1]),
            "pinned_max_abs_logit_err": err, "max_abs_logit": scale,
            "tol": tol, "first_token_agree": int(agree.sum()),
            "rows": int(rows.numel()), "decisive_rows": int(decisive.sum()),
            "router_logit_err_by_layer": router_err,
            "flips_by_layer": [int(f.sum()) for f in flips],
            "flip_worst_gap_by_layer": worst_gap,
            "unpinned_max_abs_logit_err": err_free,
            "unpinned_flips_by_layer": [int(f.sum()) for f in free_flips],
            "dropped_copies_by_layer": dropped_c,
            "lora_tiles_cuda": tiles["batched_lora_matmul"],
            "launches_cuda": launches, "repeat_bitwise": repeat or None}
    emit(line)
    want, other = (("mma", "f32") if dtype_name == "bfloat16"
                   else ("f32", "mma"))
    t = tiles["batched_lora_matmul"]
    require(t[want] > 0 and t[other] == 0,
            f"{cfg.name} {dtype_name} first chunk: batched_lora_matmul tiles "
            f"{t}, not only {want}")
    require(all(v == 0 for v in torch_launches.values()),
            f"{cfg.name}: the torch backend launched {torch_launches}")
    require(bool(torch.isfinite(lc).all()), f"{cfg.name}: cuda logits not "
            "finite")
    require(err <= tol, f"{cfg.name} {dtype_name} pinned first-chunk logit "
            f"error {err} > {tol}")
    require(bool(agree[decisive].all()), f"{cfg.name} {dtype_name}: a greedy "
            "token differs on a row whose margin exceeds the error")
    require(dropped_c == dropped_t, f"{cfg.name}: dropped copies differ, "
            f"cuda {dropped_c}, pinned torch {dropped_t}")
    return line


MOE_RANGES = (("moe_expert_bmm", "MoE expert bmm (cuBLAS)"),
              ("moe_dispatch", "MoE routing and dispatch (router product "
               "and LoRA, softmax, sort, scatter, gather, combine)"))


class MoeRanges:
    """Puts ``apply_moe`` (``moe_dispatch``) and each expert product
    (``moe_expert_bmm``) under ``record_function`` ranges for one traced
    run, by wrapping the module's functions; nothing in the package
    changes."""

    def __enter__(self):
        from torch.profiler import record_function
        from repro_torch.models import moe
        self._orig = orig_apply, orig_bmm = moe.apply_moe, moe._bmm_f32

        def apply_moe(*a, **kw):
            with record_function("moe_dispatch"):
                return orig_apply(*a, **kw)

        def bmm(*a):
            with record_function("moe_expert_bmm"):
                return orig_bmm(*a)

        moe.apply_moe, moe._bmm_f32 = apply_moe, bmm
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.apply_moe, moe._bmm_f32 = self._orig


def moe_phase(device, seed: int, T: int = 256, tenants: int = MOE_TENANTS,
              rank: int = 16, new_tokens: int = 16):
    """Each of ``MOE_FAMILY`` at its published width and the depth named
    there, bf16, seeded weights, ``tenants`` rank-16 Eq. 7-fused adapters
    (the router's pair included): ``MOE_REQUESTS`` requests (prompts from
    the seed in [128, 1024]), greedy, 16 new tokens, 256-token chunks,
    through "cuda" with overlap on and off (streams bitwise equal, every
    serving kernel launched, prefill attention and batched LoRA on their
    tensor-core tiles); one traced run with the MoE layer's expert
    products and its routing and dispatch as rows of their own; the first
    chunk against "torch" with pinned routing (``moe_first_chunk``): bf16
    (two "cuda" runs bitwise equal) and, for dbrx-132b, fp32 activations.
    Returns {arch: launch counts of its overlapped run}."""
    import dataclasses
    import gc

    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_engine, ragged_requests
    from repro_torch.models.api import Model
    from repro_torch.serving.engine import MultiTenantEngine, ServeConfig
    counts = {}
    for arch, depth in MOE_FAMILY:
        # earlier phases' engines can linger in reference cycles: free them
        # before 55 GB of weights go on the card
        gc.collect()
        torch.cuda.empty_cache()
        full = get_config(arch)
        cfg = full.with_overrides(n_layers=depth, lora_rank=rank)
        t0 = time.perf_counter()
        eng = build_engine(cfg, tenants, device, seed, rank=rank)
        torch.cuda.synchronize()
        expert_bytes = (depth * 3 * cfg.n_experts * cfg.d_model
                        * cfg.resolved_d_ff_moe * 2)
        emit({"phase": "model", "arch": cfg.name, "n_layers": depth,
              "published_n_layers": full.n_layers, "d_model": cfg.d_model,
              "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
              "head_dim": cfg.resolved_head_dim,
              "n_experts": cfg.n_experts, "top_k": cfg.n_experts_per_tok,
              "d_ff_moe": cfg.resolved_d_ff_moe,
              "capacity_factor": cfg.moe_capacity_factor,
              "vocab_size": cfg.vocab_size, "norm_type": cfg.norm_type,
              "params": cfg.count_params(),
              "active_params": cfg.count_active_params(),
              "expert_weight_bytes": expert_bytes, "dtype": cfg.dtype,
              "tenants": tenants, "rank": rank,
              "init_s": time.perf_counter() - t0,
              "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9})
        reqs = ragged_requests(MOE_REQUESTS, tenants, cfg.vocab_size, 128,
                               1024, seed)
        sc = ServeConfig(batch_size=len(reqs), max_new_tokens=new_tokens,
                         prefill_chunk=T, block_size=16, paged_backend="cuda")
        eng.generate(ragged_requests(2, tenants, cfg.vocab_size, 8, 16,
                                     seed + 1),
                     ServeConfig(batch_size=2, max_new_tokens=2,
                                 prefill_chunk=8, paged_backend="cuda"))
        streams = {}
        for overlap in (True, False):
            sc.overlap = overlap
            kernels.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            outs, ttft, dec_s, dec_tok, total_s = timed_generate(eng, reqs,
                                                                 sc)
            launches = kernels.launch_counts()
            tiles = kernels.tile_counts()
            st = eng.last_stats
            steps = st["decode_dispatches"]
            # a decode step reads every expert's weights (cap rounds up to
            # 64 slots an expert): the byte bound of one step at 3.35 TB/s
            bound_step_ms = expert_bytes / HBM_BYTES_PER_S * 1e3
            emit({"phase": "serve", "arch": cfg.name, "backend": "cuda",
                  "overlap": overlap, "requests": len(reqs),
                  "prompt_lens": [len(r.prompt) for r in reqs],
                  "new_tokens": new_tokens, "prefill_chunk": T,
                  "tokens": sum(len(o) for o in outs),
                  "ttft_ms_p50": float(np.percentile(ttft, 50)) * 1e3,
                  "ttft_ms_max": max(ttft) * 1e3,
                  "decode_tokens": dec_tok, "decode_s": dec_s,
                  "decode_tok_per_s": dec_tok / dec_s if dec_s > 0 else None,
                  "expert_read_bound_ms_per_step": bound_step_ms,
                  "expert_read_bound_tok_per_s":
                      len(reqs) / bound_step_ms * 1e3,
                  "total_s": total_s,
                  "prefill_dispatches": st["prefill_dispatches"],
                  "decode_dispatches": steps,
                  "launches": launches, "tile_launches": tiles,
                  "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
            for o in outs:
                require(len(o) == new_tokens
                        and all(0 <= t < cfg.vocab_size for t in o),
                        f"{arch}: a stream is malformed")
            for name in kernels.SERVING:
                require(launches[name] > 0, f"{arch}: kernel {name} was "
                        "never launched on the serving path")
            for name in ("paged_prefill_attention", "batched_lora_matmul"):
                require_mma_tile(tiles, name, f"{arch} overlap={overlap}")
            streams[overlap] = outs
            if overlap:
                counts[arch] = launches
        require(streams[True] == streams[False],
                f"{arch}: streams with overlap on and off differ")
        if arch == MOE_FAMILY[0][0]:
            with MoeRanges():
                wall_ms, fam = traced(
                    lambda: eng.generate(reqs, dataclasses.replace(
                        sc, overlap=True)), KERNEL_FAMILIES,
                    "other device work (torch: lm_head, norms, rope, "
                    "scatter, sampling, copies)", ranges=MOE_RANGES)
            emit(_profile_line(fam, wall_ms, phase="profile_moe",
                               arch=cfg.name, requests=len(reqs),
                               new_tokens=new_tokens, **_decode_share(fam)))
        moe_first_chunk(eng, reqs, sc, "bfloat16", rel_tol=0.1, repeat=True)
        if arch == MOE_FAMILY[0][0]:
            cfg32 = eng.cfg.with_overrides(dtype="float32")
            eng32 = MultiTenantEngine(Model(cfg32, device), cfg32,
                                      eng.params, eng.registry)
            moe_first_chunk(eng32, reqs, sc, "float32", rel_tol=1e-2)
            del eng32
        del eng
    return counts


def ptxas_entries(report: str):
    """``{kernel: {registers, spill_stores, spill_loads}}`` from ``nvcc
    -Xptxas=-v`` output.  The tensor-core tiles are named
    ``<kernel><hd or LoRA tile kind[, int8]>`` and the decode kernels
    ``<kernel><pool type, hd, heads>`` from their mangled names; others
    keep theirs."""
    import re
    out, name = {}, None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            t = re.search(r"\d+([a-z][a-z_]*_mma_kernel)ILi(\d+)E(a?)", name)
            u = re.search(r"\d+(lora_mma_[a-z_]+?_kernel)(?:I([af])E)?",
                          name)
            d = re.search(r"\d+(paged_decode_[a-z]+_kernel)"
                          r"(?:ILb([01])ELi(\d+)ELi(\d+)E)?", name)
            if d:
                name = d.group(1) + (
                    f"<{'int8' if d.group(2) == '1' else 'bf16'}, hd "
                    f"{d.group(3)}, heads {d.group(4)}>" if d.group(2)
                    else "")
            elif t:
                name = f"{t.group(1)}<{t.group(2)}" + (
                    ", int8>" if t.group(3) else ">")
            elif u:
                name = u.group(1) + {"a": "<int8>", "f": "<fp32>"}.get(
                    u.group(2), "")
            out[name] = {"registers": None, "spill_stores": 0,
                         "spill_loads": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def card_identity():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


KERNEL_ROWS = {
    "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:87"),
    "paged_prefill_attention": ("src/repro_torch/kernels/csrc/paged_prefill.cu",
                                "src/repro/kernels/paged_prefill.py:166"),
    "batched_lora_matmul": ("src/repro_torch/kernels/csrc/batched_lora.cu",
                            "src/repro/kernels/batched_lora.py:153"),
    "lora_matmul": ("src/repro_torch/kernels/csrc/lora_matmul.cu",
                    "src/repro/kernels/lora_matmul.py:52"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:81"),
    "dual_lora_matmul": ("src/repro_torch/kernels/csrc/dual_lora.cu",
                         "src/repro/kernels/dual_lora.py:51"),
    "batched_dual_lora_matmul": (
        "src/repro_torch/kernels/csrc/batched_dual_lora.cu",
        "src/repro/kernels/batched_lora.py:224"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20,
                    help="timed repetitions per kernel")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found; run "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    reports = build.build()
    ptxas = {n: ptxas_entries(rep) for n, rep in reports.items()}
    mma = {f"{src}: {k}": v for src, ent in ptxas.items()
           for k, v in ent.items() if "_mma_" in k or "lmma" in k}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(reports), "ptxas": ptxas,
          "tensor_core_tiles": mma})
    for src in ("paged_prefill", "flash_attention", "batched_lora",
                "lora_matmul", "dual_lora", "batched_dual_lora"):
        if src in reports:
            require(any("_mma_kernel" in k for k in ptxas[src]),
                    f"no tensor-core tile in the ptxas report of {src}.cu")
    spilled = {k: v for k, v in mma.items()
               if v["spill_stores"] or v["spill_loads"]}
    require(not spilled, f"tensor-core tiles spill registers: {spilled}")
    for src, tile in (("paged_prefill", "paged_prefill_mma_kernel<256>"),
                      ("paged_prefill", "paged_prefill_mma_kernel<256, int8>"),
                      ("flash_attention", "flash_attn_mma_kernel<256>")):
        if src in reports:
            require(tile in ptxas[src], f"no head-dim-256 tile {tile} in the "
                    f"ptxas report of {src}.cu")
    if "paged_attention" in reports:
        dec = ptxas["paged_attention"]
        require(any(k.startswith("paged_decode_split_kernel<") for k in dec)
                and "paged_decode_combine_kernel" in dec,
                "no split-K decode kernels in the ptxas report of "
                "paged_attention.cu")
        spilled = {k: v for k, v in dec.items()
                   if v["spill_stores"] or v["spill_loads"]}
        require(not spilled, f"decode kernels spill registers: {spilled}")

    import numpy as np
    rng = np.random.default_rng(args.seed)
    n_requests, T = 8, 256
    prompt_lens = sorted(int(n) for n in rng.integers(128, 1025, n_requests))
    seconds = {}                       # wall seconds by phase

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t
        return out

    t_kernels = time.perf_counter()
    main_shapes = kernel_phase(device, args.seed, args.reps, prompt_lens, T)
    main_shapes["batched_dual_lora_matmul"], dual_launches = \
        dual_entry_point(device, args.seed, args.reps, n_requests, T)
    main_shapes.update(training_kernels(
        device, args.seed, args.reps,
        {k: v["registers"] for k, v in ptxas.get("lora_matmul", {}).items()}))
    seconds["kernels"] = time.perf_counter() - t_kernels
    serve_counts, eng, err_bf16 = timed("serve", serve_phase, device,
                                        args.seed, n_requests, 32, 128,
                                        1024, T)
    torch.cuda.empty_cache()            # the serving pools are gone
    timed("serve_trace", serve_trace_phase, eng, args.seed, err_bf16)
    params = eng.params
    del eng
    torch.cuda.empty_cache()
    from repro_torch import kernels
    from repro_torch.configs import get_config
    timed("serve_options", serve_options_phase, device, args.seed, params,
          get_config(ARCH), T)
    torch.cuda.empty_cache()
    sharded_counts, eng1 = timed("sharded", sharded_phase, device,
                                 args.seed, params, get_config(ARCH),
                                 prompt_lens, T)
    fixed_launches = timed("fixed", fixed_phase, eng1, args.seed)
    del eng1
    torch.cuda.empty_cache()
    train_counts, fdlora_accuracy = timed("train", train_phase, device,
                                          args.seed, params, get_config(ARCH))
    timed("baselines", baselines_phase, device, args.seed, params,
          get_config(ARCH), fdlora_accuracy)
    del params                          # llama2-7b's weights
    torch.cuda.empty_cache()
    timed("dense_family", dense_family_phase, device, args.seed, T)
    moe_counts = timed("moe", moe_phase, device, args.seed, T)
    # each kernel's launches on its own path's run; the standalone kernel's
    # at its entry point
    counts = {**{n: serve_counts[n] for n in kernels.SERVING},
              **{n: train_counts[n] for n in kernels.TRAINING},
              "batched_dual_lora_matmul": dual_launches}
    # this slice's paths, each read just after its own run
    emit({"phase": "path_launches", "sharded": {
        n: sharded_counts[n] for n in kernels.SERVING},
        "fixed": fixed_launches,
        "moe": {arch: {n: c[n] for n in kernels.SERVING}
                for arch, c in moe_counts.items()}})
    emit({"phase": "total", "seconds": time.perf_counter() - t0,
          "by_phase": seconds})

    print(card_identity(), flush=True)
    rows = []
    for name, (source, replaces) in KERNEL_ROWS.items():
        res = main_shapes[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": counts[name],
                     "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                     "device_ms": res["device_ms"],
                     "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                     "bound_by": res["bound_by"],
                     "library_ms": res["library_ms"],
                     **({"library_device_ms": res["library_device_ms"]}
                        if "library_device_ms" in res else {})})
    emit({"phase": "device_traces", "retaken": len(DEVICE_TRACE_RETAKES),
          "retakes": DEVICE_TRACE_RETAKES})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
