#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card and check it end to end.

    python3 chip_smoke.py            # from the root of a checkout

Phases (each prints one JSON line per result):
  1. build   — compile every CUDA kernel of the serving path from
               src/repro_torch/kernels/csrc (one nvcc per source, in parallel);
  2. kernels — hold each kernel against its plain PyTorch version on the card
               at the main path's shapes and variants (bf16 and int8 K/V,
               GQA groups 1 and 4, ragged lengths with an empty row, rank
               mask, int8 bank); time kernel, plain version and one library
               call computing the same function (a yardstick the port never
               calls);
  3. serve   — llama2-7b at full width, 32 layers, bf16, random weights from
               --seed, 8 tenants with non-zero rank-16 adapters: 8 ragged
               requests (prompts 128-1024 tokens, 32 new tokens) through
               MultiTenantEngine.generate with paged_backend="cuda", counting
               kernel launches; then the same requests with "torch", holding
               first-chunk logits and greedy tokens to stated tolerances;
  4. the card's name and power limit, the kernel summary line, and last the
     result line.

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


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
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


def _gathered(k_pool, v_pool, ks, vs, bt, H):
    """K/V gathered per row and expanded to H heads, (B, H, L, hd) bf16 —
    the library yardstick's input, prepared outside its timing."""
    from repro_torch.kernels.ref import _gather_pool
    Kv = k_pool.shape[2]
    k = _gather_pool(k_pool, ks, bt, H // Kv)
    v = _gather_pool(v_pool, vs, bt, H // Kv)
    return (k.permute(0, 2, 1, 3).contiguous(),
            v.permute(0, 2, 1, 3).contiguous())


def check_decode(gen, device, lengths, G, int8, reps, H=32, hd=128, bs=16):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_ref)
    B = len(lengths)
    Kv = H // G
    MB = -(-max(lengths) // bs)
    kp, vp, ks, vs = _pools(gen, 1 + B * MB, bs, Kv, hd, device, int8)
    bt = _tables(gen, B, MB, device)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    q = torch.randn((B, H, hd), generator=gen, device=device).to(torch.bfloat16)
    out = paged_attention(q, kp, vp, bt, lens, k_scale=ks, v_scale=vs)
    ref = paged_attention_ref(q, kp, vp, bt, lens, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    tol = _bf16_tol(ref)
    require(bool(torch.isfinite(out.float()).all()), "decode output not finite")
    require(err <= tol, f"paged_attention G={G} int8={int8}: err {err} > {tol}")
    zero_rows = [i for i, n in enumerate(lengths) if n == 0]
    require(all(float(out[i].float().abs().max()) == 0.0 for i in zero_rows),
            "an empty decode row is not zero")
    ms = time_ms(lambda: paged_attention(q, kp, vp, bt, lens, k_scale=ks,
                                         v_scale=vs), reps)
    plain_ms = time_ms(lambda: paged_attention_ref(
        q, kp, vp, bt, lens, k_scale=ks, v_scale=vs), max(1, reps // 4), 1)
    kg, vg = _gathered(kp, vp, ks, vs, bt, H)
    kg, vg = kg.to(torch.bfloat16), vg.to(torch.bfloat16)
    L = kg.shape[2]
    mask = (torch.arange(L, device=device)[None, :]
            < lens[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, kg, vg, attn_mask=mask), reps)
    ctx = int(sum(lengths))
    kv_bytes = (1 if int8 else 2) * 2 * ctx * Kv * hd + (8 * ctx * Kv if int8
                                                          else 0)
    nbytes = kv_bytes + 2 * 2 * B * H * hd + 4 * B * (MB + 1)
    flops = 4 * hd * H * ctx
    b_ms, b_by = bound(nbytes, flops)
    return {"name": "paged_attention", "G": G, "kv": "int8" if int8 else "bf16",
            "B": B, "H": H, "hd": hd, "bs": bs, "lengths": lengths,
            "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by}


def check_prefill(gen, device, lengths, T, G, int8, reps, H=32, hd=128,
                  bs=16):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_prefill import (paged_prefill_attention,
                                                   paged_prefill_attention_ref)
    B = len(lengths)
    Kv = H // G
    MB = -(-(max(lengths) + T) // bs)
    kp, vp, ks, vs = _pools(gen, 1 + B * MB, bs, Kv, hd, device, int8)
    bt = _tables(gen, B, MB, device)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    q = torch.randn((B, T, H, hd), generator=gen,
                    device=device).to(torch.bfloat16)
    out = paged_prefill_attention(q, kp, vp, bt, lens, k_scale=ks, v_scale=vs)
    ref = paged_prefill_attention_ref(q, kp, vp, bt, lens, k_scale=ks,
                                      v_scale=vs)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    tol = _bf16_tol(ref)
    require(bool(torch.isfinite(out.float()).all()), "prefill output not finite")
    require(err <= tol, f"paged_prefill G={G} int8={int8}: err {err} > {tol}")
    ms = time_ms(lambda: paged_prefill_attention(q, kp, vp, bt, lens,
                                                 k_scale=ks, v_scale=vs), reps)
    plain_ms = time_ms(lambda: paged_prefill_attention_ref(
        q, kp, vp, bt, lens, k_scale=ks, v_scale=vs), max(1, reps // 4), 1)
    kg, vg = _gathered(kp, vp, ks, vs, bt, H)
    kg, vg = kg.to(torch.bfloat16), vg.to(torch.bfloat16)
    L = kg.shape[2]
    q_pos = lens[:, None] + torch.arange(T, device=device)[None, :]
    mask = (torch.arange(L, device=device)[None, None, :]
            <= q_pos[:, :, None])[:, None]
    qt = q.permute(0, 2, 1, 3).contiguous()
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kg, vg, attn_mask=mask), reps)
    ctx = sum(n + T for n in lengths)                 # positions read per row
    pairs = sum((n + 1) * T + T * (T - 1) // 2 for n in lengths)
    kv_bytes = (1 if int8 else 2) * 2 * ctx * Kv * hd + (8 * ctx * Kv if int8
                                                          else 0)
    nbytes = kv_bytes + 2 * 2 * B * T * H * hd + 4 * B * (MB + 1)
    flops = 4 * hd * H * pairs
    b_ms, b_by = bound(nbytes, flops)
    return {"name": "paged_prefill_attention", "G": G,
            "kv": "int8" if int8 else "bf16", "B": B, "T": T, "H": H,
            "hd": hd, "bs": bs, "lengths": lengths, "max_abs_err": err,
            "tol": tol, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by}


def check_lora(gen, device, M, K, N, C, r, variant, reps):
    import torch
    from repro_torch.kernels.batched_lora import (batched_lora_matmul,
                                                  batched_lora_matmul_ref)
    from repro_torch.kernels.quant import quantize_int8
    x = torch.randn((M, K), generator=gen, device=device).to(torch.bfloat16)
    w = (torch.randn((K, N), generator=gen, device=device)
         * K ** -0.5).to(torch.bfloat16)
    a = torch.randn((C, K, r), generator=gen, device=device) / r
    b = torch.randn((C, r, N), generator=gen, device=device) * 0.02
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
    out = batched_lora_matmul(x, w, a, b, ids, scale, **kw)
    ref = batched_lora_matmul_ref(x, w, a, b, ids, scale, **kw)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    tol = _bf16_tol(ref)
    require(bool(torch.isfinite(out.float()).all()), "lora output not finite")
    require(err <= tol, f"batched_lora {variant} M={M}: err {err} > {tol}")
    ms = time_ms(lambda: batched_lora_matmul(x, w, a, b, ids, scale, **kw),
                 reps)
    plain_ms = time_ms(lambda: batched_lora_matmul_ref(
        x, w, a, b, ids, scale, **kw), max(1, reps // 4), 1)
    library_ms = time_ms(lambda: torch.matmul(x, w), reps)
    active = int(torch.unique(ids).numel())
    bank_el = 1 if variant == "int8_bank" else 4
    nbytes = (2 * M * K + 2 * K * N + 2 * M * N + 4 * M
              + active * bank_el * r * (K + N))
    flops = 2 * M * K * N + 2 * M * r * (K + N)
    b_ms, b_by = bound(nbytes, flops)
    return {"name": "batched_lora_matmul", "variant": variant, "M": M,
            "K": K, "N": N, "C": C, "r": r, "max_abs_err": err, "tol": tol,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": b_by}


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
    # prefill: a chunk of T behind ragged earlier context, one fresh row
    pre_lengths = [0] + [min(n, 768) for n in main_lengths[1:]]
    for G in (1, 4):
        for int8 in (False, True):
            res = check_prefill(gen, device, pre_lengths, T, G, int8, reps)
            emit(res)
            if G == 1 and not int8:
                main["paged_prefill_attention"] = res
    B = len(main_lengths)
    for M, K, N in ((B, 4096, 4096), (B * T, 4096, 11008)):
        for variant in ("f32_bank", "rank_mask", "int8_bank"):
            res = check_lora(gen, device, M, K, N, 8, 16, variant, reps)
            emit(res)
            if M == B * T and variant == "f32_bank":
                main["batched_lora_matmul"] = res
    return main


# ---------------------------------------------------------------------------
# phase 3: the serving path
# ---------------------------------------------------------------------------

def first_chunk_logits(eng, reqs, sc, backend):
    """Logits of the first prefill dispatch the engine would make for
    ``reqs`` (all slots admitted, fresh pool), through ``backend``."""
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
    cache = eng.model.init_paged_decode_cache(1 + B * per, sc.block_size)
    logits, _ = eng.model.prefill_step(
        eng.params, cache, tokens.to(dev), lens, n_new.to(dev),
        adapters=eng.registry.bank(), lora_scale=eng.scale, adapter_ids=ids,
        block_tables=bt, paged_backend=backend)
    return logits, n_new


def compare_first_chunk(eng, reqs, sc, dtype_name, rel_tol, extra=None):
    """First prefill chunk through "cuda" and "torch" on fresh pools: the
    max logit error must stay within ``rel_tol`` of the largest logit, and
    each row's greedy token must agree wherever the torch path's top-2
    margin exceeds twice that error."""
    import torch
    lc, n_new = first_chunk_logits(eng, reqs, sc, "cuda")
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
          **(extra or {})})
    require(bool(torch.isfinite(lc).all()), "cuda logits not finite")
    require(err <= tol, f"{dtype_name} first-chunk logit error {err} > {tol}")
    require(bool(agree[decisive].all()),
            "greedy token differs on a row whose margin exceeds the error")


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
        now = time.perf_counter()             # events come after a sync
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
    for backend in ("cuda", "torch"):
        sc.paged_backend = backend
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        outs, ttft, dec_s, dec_tok, total_s = timed_generate(eng, reqs, sc)
        counts = kernels.launch_counts()
        st = eng.last_stats
        results[backend] = (outs, counts)
        emit({"phase": "serve", "backend": backend, "requests": len(reqs),
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
              "preemptions": st["preemptions"], "launches": counts,
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
        for o in outs:
            require(len(o) == new_tokens and all(0 <= t < cfg.vocab_size
                                                 for t in o),
                    f"{backend}: a stream is malformed")
    cuda_counts = results["cuda"][1]
    for name, n in cuda_counts.items():
        require(n > 0, f"kernel {name} was never launched on the main path")
    require(all(n == 0 for n in results["torch"][1].values()),
            "the torch backend launched a CUDA kernel")

    streams_c, streams_t = results["cuda"][0], results["torch"][0]
    matched = [next((i for i, (a, b) in enumerate(zip(c, t)) if a != b),
                    len(c)) for c, t in zip(streams_c, streams_t)]
    # bf16: the two paths round activations at different places (the LoRA
    # epilogue rounds once where the torch path rounds twice; attention
    # probabilities stay fp32 in the kernels), 224 projections deep.  The
    # bound is a sanity bound: a wrong mask or a lost LoRA term moves logits
    # by O(their largest value).
    compare_first_chunk(eng, reqs, sc, "bfloat16", rel_tol=0.1,
                        extra={"stream_prefix_matched": matched,
                               "stream_tokens_agree_fraction":
                                   sum(matched) / sum(len(c)
                                                      for c in streams_c)})
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
    profile_phase(eng, reqs, sc)
    return cuda_counts


KERNEL_FAMILIES = (("paged_decode_kernel", "paged_attention"),
                   ("paged_prefill_kernel", "paged_prefill_attention"),
                   ("lora_matmul_kernel", "batched_lora_matmul (x.W + epilogue)"),
                   ("lora_shrink_kernel", "batched_lora_matmul (shrink)"))


def profile_phase(eng, reqs, sc, new_tokens: int = 8):
    """One traced serving run (``torch.profiler``, CPU + CUDA activity):
    device time by kernel family and the device's idle share of the traced
    wall time.  Tracing slows the host, so the idle share is an upper
    bound; the untraced runs above give the end-to-end numbers."""
    import dataclasses

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sc2 = dataclasses.replace(sc, max_new_tokens=new_tokens,
                              paged_backend="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(reqs, sc2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fam = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = (getattr(ev, "self_device_time_total", None)
              or getattr(ev, "self_cuda_time_total", 0))
        name = next((f for k, f in KERNEL_FAMILIES if k in ev.key),
                    "other device work (torch: lm_head, norms, rope, "
                    "scatter, sampling, copies)")
        fam[name] = fam.get(name, 0.0) + us / 1e3
    busy_ms = sum(fam.values())
    emit({"phase": "profile", "requests": len(reqs), "new_tokens": new_tokens,
          "traced_wall_ms": wall * 1e3,
          "device_busy_ms": busy_ms if fam else "not measured",
          "device_idle_share": (1 - busy_ms / (wall * 1e3)) if fam
          else "not measured",
          "device_ms_by_kernel": dict(sorted(fam.items(),
                                             key=lambda kv: -kv[1]))})


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
    ptxas = {n: [ln.strip() for ln in rep.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, rep in reports.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(reports), "ptxas": ptxas})

    import numpy as np
    rng = np.random.default_rng(args.seed)
    n_requests, T = 8, 256
    prompt_lens = sorted(int(n) for n in rng.integers(128, 1025, n_requests))
    main_shapes = kernel_phase(device, args.seed, args.reps, prompt_lens, T)
    counts = serve_phase(device, args.seed, n_requests, 32, 128, 1024, T)

    print(card_identity(), flush=True)
    rows = []
    for name, (source, replaces) in KERNEL_ROWS.items():
        res = main_shapes[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": counts[name],
                     "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                     "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                     "bound_by": res["bound_by"],
                     "library_ms": res["library_ms"]})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
