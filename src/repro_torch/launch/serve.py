"""Serving CLI of the port: multi-tenant continuous batching.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
        --tenants 8 --batch 8 --requests 8 --new-tokens 32 \
        --prefill-chunk 256 --block-size 16 --paged-backend cuda

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
        --smoke --device cpu --paged-backend torch --tenants 3 --batch 2

Weights and adapters are random from ``--seed`` (the repo holds no trained
weights); each tenant registers one Eq. 7-fused adapter with a non-zero B.
Flag names are the reference CLI's (``repro.launch.serve``) for the subset
the port serves.
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


def build_engine(cfg, tenants: int, device, seed: int = 0,
                 rank=None) -> MultiTenantEngine:
    """Random base weights plus ``tenants`` registered fused adapters."""
    model = Model(cfg, device=device)
    params = model.init(seed)
    registry = AdapterRegistry(cfg, capacity=tenants, rank=rank,
                               device=device)
    for i in range(tenants):
        ad_p = init_adapters(cfg, rank, seed=10 + 2 * i, device=device,
                             b_std=0.02)
        ad_s = init_adapters(cfg, rank, seed=11 + 2 * i, device=device,
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
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    eng = build_engine(cfg, args.tenants, args.device, args.seed)
    sc = ServeConfig(batch_size=args.batch, max_new_tokens=args.new_tokens,
                     prefill_chunk=args.prefill_chunk,
                     block_size=args.block_size,
                     sched_policy=args.sched_policy,
                     paged_backend=args.paged_backend)
    reqs = ragged_requests(args.requests or 2 * args.batch, args.tenants,
                           cfg.vocab_size, args.prompt_min, args.prompt_max,
                           args.seed)
    t0 = time.perf_counter()
    outs = eng.generate(reqs, sc)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.perf_counter() - t0
    st = eng.last_stats
    total = sum(o.size for o in outs)
    print(f"{args.tenants} tenants, {len(reqs)} ragged requests over "
          f"{args.batch} slots on {eng.device}: {total} tokens in {dt:.3f}s "
          f"({st['prefill_dispatches']} prefill + "
          f"{st['decode_dispatches']} decode dispatches, "
          f"{st['preemptions']} preemptions, backend="
          f"{args.paged_backend or ('cuda' if eng.device.type == 'cuda' else 'torch')})")
    for r, o in list(zip(reqs, outs))[:args.tenants]:
        print(f"  {r.client_id} (S={len(r.prompt)}): {o[:12].tolist()}")


if __name__ == "__main__":
    main()
