"""Serving CLI of the port: multi-tenant continuous batching.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
        --tenants 8 --batch 8 --requests 8 --new-tokens 32 \
        --prefill-chunk 256 --block-size 16 --paged-backend cuda

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
        --smoke --device cpu --paged-backend torch --tenants 3 --batch 2

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke \
        --kv-dtype int8 --ranks 4,8 --bank-dtype int8 --prefix-cache \
        --spec-decode

Weights and adapters are random from ``--seed`` (the repo holds no trained
weights); each tenant registers one Eq. 7-fused adapter with a non-zero B.
Flag names are the reference CLI's (``repro.launch.serve``) for the subset
the port serves, plus ``--bank-dtype``.  With ``--prefix-cache`` the
requests run twice, the second time against the warm pool.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core.lora import init_adapters
from repro_torch.models.api import Model
from repro_torch.serving.engine import MultiTenantEngine, Request, ServeConfig
from repro_torch.serving.registry import AdapterRegistry


def build_engine(cfg, tenants: int, device, seed: int = 0, rank=None,
                 ranks=None, bank_dtype: str = "f32") -> MultiTenantEngine:
    """Random base weights plus ``tenants`` registered fused adapters.
    ``rank`` sets the model's ``lora_rank`` (and so the scale α/r the
    engine serves with); ``ranks`` makes a ragged bank with client i at
    ``ranks[i % len(ranks)]`` and twice the tenants' slots, as the
    reference CLI does."""
    if rank:
        cfg = cfg.with_overrides(lora_rank=rank)
    model = Model(cfg, device=device)
    params = model.init(seed)
    cap = 2 * tenants if ranks else tenants
    registry = AdapterRegistry(cfg, capacity=cap, ranks=ranks or None,
                               bank_dtype=bank_dtype, device=device)
    for i in range(tenants):
        rk = ranks[i % len(ranks)] if ranks else None
        ad_p = init_adapters(cfg, rk, seed=10 + 2 * i, device=device,
                             b_std=0.02)
        ad_s = init_adapters(cfg, rk, seed=11 + 2 * i, device=device,
                             b_std=0.02)
        registry.register_dual(f"client{i}", ad_p, ad_s, [0.6, 0.6])
    return MultiTenantEngine(model, cfg, params, registry)


def ragged_requests(n: int, tenants: int, vocab: int, prompt_min: int,
                    prompt_max: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(prompt_min, prompt_max + 1, n)
    return [Request(f"client{i % tenants}",
                    rng.integers(0, vocab, int(s)).astype(np.int32))
            for i, s in enumerate(lens)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b", choices=ALL_ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=0,
                    help="queued requests (default 2x batch)")
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--prompt-min", type=int, default=8)
    ap.add_argument("--prompt-max", type=int, default=32)
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--paged-backend", default=None, choices=["cuda", "torch"],
                    help="default: 'cuda' on a card, 'torch' on the CPU")
    ap.add_argument("--sched-policy", default="sla", choices=["sla", "fcfs"])
    ap.add_argument("--kv-dtype", default="f32", choices=["f32", "int8"],
                    help="paged K/V storage: 'int8' quantizes blocks with "
                         "per-(block, position, kv-head) scales")
    ap.add_argument("--bank-dtype", default="f32", choices=["f32", "int8"],
                    help="adapter bank storage: 'int8' quantizes each "
                         "client's factors per layer")
    ap.add_argument("--ranks", default="",
                    help="comma list of rank buckets (e.g. '4,8'): client "
                         "i registers at ranks[i %% len], padded into its "
                         "bucket")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="content-addressed shared K/V blocks within and "
                         "across calls (runs the requests twice to show "
                         "the warm hit rate)")
    ap.add_argument("--spec-decode", action="store_true",
                    help="greedy speculative decoding with prompt-lookup "
                         "drafts (tokens equal to plain decoding)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="with --spec-decode: max drafted tokens per slot "
                         "per verify round")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    ranks = [int(r) for r in args.ranks.split(",") if r.strip()]
    eng = build_engine(cfg, args.tenants, args.device, args.seed,
                       ranks=ranks or None, bank_dtype=args.bank_dtype)
    if ranks:
        print(f"ragged adapter bank: buckets {eng.registry.bucket_ranks}, "
              f"per-slot ranks {eng.registry.slot_ranks().tolist()}")
    sc = ServeConfig(batch_size=args.batch, max_new_tokens=args.new_tokens,
                     prefill_chunk=args.prefill_chunk,
                     block_size=args.block_size,
                     sched_policy=args.sched_policy,
                     paged_backend=args.paged_backend,
                     kv_dtype=args.kv_dtype, prefix_cache=args.prefix_cache,
                     spec_decode=args.spec_decode, spec_k=args.spec_k)
    reqs = ragged_requests(args.requests or 2 * args.batch, args.tenants,
                           cfg.vocab_size, args.prompt_min, args.prompt_max,
                           args.seed)
    backend = args.paged_backend or ("cuda" if eng.device.type == "cuda"
                                     else "torch")
    for run in ("cold", "warm") if args.prefix_cache else ("cold",):
        t0 = time.perf_counter()
        outs = eng.generate(reqs, sc)
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
        dt = time.perf_counter() - t0
        st = eng.last_stats
        total = sum(o.size for o in outs)
        print(f"{args.tenants} tenants, {len(reqs)} ragged requests over "
              f"{args.batch} slots on {eng.device}: {total} tokens in "
              f"{dt:.3f}s ({st['prefill_dispatches']} prefill + "
              f"{st['decode_dispatches']} decode + "
              f"{st['verify_dispatches']} verify dispatches, "
              f"{st['preemptions']} preemptions, backend={backend}, "
              f"kv={sc.kv_dtype}, bank={args.bank_dtype})")
        if args.prefix_cache:
            print(f"  prefix cache ({run}): {st['prefix_hit_tokens']} of "
                  f"{st['prompt_tokens']} prompt tokens hit, pool reused "
                  f"{st['prefix_pool_reused']}")
        if args.spec_decode:
            print(f"  spec decode (k={sc.spec_k}): "
                  f"{st['accepted_tokens']}/{st['drafted_tokens']} drafts "
                  f"accepted, {st['rollback_tokens']} rolled back")
    for r, o in list(zip(reqs, outs))[:args.tenants]:
        print(f"  {r.client_id} (S={len(r.prompt)}): {o[:12].tolist()}")


if __name__ == "__main__":
    main()
