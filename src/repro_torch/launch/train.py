"""Training CLI of the port: LoRA SFT (the paper's inner loop).

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --steps 20

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama2-7b \
        --steps 10 --batch 8 --seq 256 --ckpt out/adapters.npz

Flag names are the reference CLI's (``repro.launch.train``), plus
``--device`` (default ``cuda``; a missing card raises) and
``--paged-backend`` (default: ``"cuda"`` kernels on a card, the plain
``"torch"`` path on the CPU).  Base weights are random from seed 0 (the
repo holds no trained weights); the adapters start at the standard LoRA
init (B = 0), from seed 1.  ``--ckpt`` writes the adapters in the reference's npz
layout.  The first line names the mesh, as the reference's does: the
host mesh's ("data", "model") shape over the running process group's
ranks (one when none runs; no group is started for it).  A VLM (``internvl2-26b``) or an encoder-decoder
(``whisper-small``) needs modality inputs whose frontend is a stub: each
batch carries zero patch embeddings (B, n_patch_tokens, d) or frame
embeddings (B, encoder_seq_len, d) beside the synthetic text, as the
reference CLI feeds them.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core.lora import init_adapters
from repro_torch.data.pipeline import SFTBatcher
from repro_torch.data.synthetic import gen_log_dataset
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models.api import Model
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.optimizers import adamw, cosine_schedule
from repro_torch.training.train_step import make_lora_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b", choices=ALL_ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=160)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--paged-backend", default=None, choices=["cuda", "torch"],
                    help="default: 'cuda' on a card, 'torch' on the CPU")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.is_encdec or cfg.family == "vlm":
        print(f"note: {args.arch} needs modality inputs; feeding stub "
              "embeddings alongside synthetic text")
    model = Model(cfg, device=args.device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    print(f"mesh: {{'data': {world}, 'model': 1}}, arch: {cfg.name} "
          f"({cfg.count_params() / 1e6:.1f}M params, "
          f"LoRA {cfg.count_lora_params() / 1e3:.1f}K) on {model.device}")
    params = model.init(0)
    adapters = init_adapters(cfg, seed=1, device=model.device)
    opt = adamw(lr=args.lr, schedule=cosine_schedule(10, args.steps))
    state = opt.init(adapters)
    step = make_lora_train_step(model, cfg, opt,
                                paged_backend=args.paged_backend)

    tok = ByteTokenizer()
    rng = np.random.default_rng(0)
    seq = min(args.seq, cfg.max_seq_len)
    batcher = SFTBatcher(gen_log_dataset(rng, 256, 0), tok, seq, args.batch)

    t0 = time.perf_counter()
    for i in range(args.steps):
        raw = batcher.sample()
        batch = {"tokens": torch.as_tensor(raw["tokens"] % cfg.vocab_size),
                 "loss_mask": torch.as_tensor(raw["loss_mask"])}
        if cfg.family == "vlm":
            batch["patch_embeds"] = torch.zeros(
                (args.batch, cfg.n_patch_tokens, cfg.d_model))
        if cfg.is_encdec:
            batch["enc_embeds"] = torch.zeros(
                (args.batch, cfg.encoder_seq_len, cfg.d_model))
        batch = {k: v.to(model.device) for k, v in batch.items()}
        adapters, state, m = step(params, adapters, state, batch)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(m['loss']):.4f}  "
                  f"acc {float(m['accuracy']):.3f}  "
                  f"{(time.perf_counter() - t0) / (i + 1):.2f}s/step")
    if args.ckpt:
        save_checkpoint(args.ckpt, adapters, {"arch": args.arch,
                                              "steps": args.steps})
        print("saved adapters to", args.ckpt)
    return adapters


if __name__ == "__main__":
    main()
