"""Quickstart on the PyTorch/CUDA port: LoRA-SFT a small backbone on
synthetic log-anomaly data and generate with the tuned adapter.

    PYTHONPATH=src python examples/torch_quickstart.py [--steps 60] [--device cuda]

On a card every adapted projection runs the ``lora_matmul`` kernel and
every attention of a train step the flash-attention kernel; ``--device
cpu`` runs their plain versions.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lora import init_adapters, lora_scale
from repro_torch.data.pipeline import SFTBatcher
from repro_torch.data.synthetic import answer_accuracy, gen_log_dataset
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models.api import Model
from repro_torch.serving.engine import Engine, ServeConfig
from repro_torch.training.optimizers import adamw
from repro_torch.training.train_step import make_lora_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = ModelConfig(name="quickstart", family="dense", n_layers=2,
                      d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                      vocab_size=300, max_seq_len=192, lora_rank=8,
                      dtype="float32", param_dtype="float32")
    model = Model(cfg, args.device)
    params = model.init(0)

    rng = np.random.default_rng(0)
    tok = ByteTokenizer()
    train = gen_log_dataset(rng, 200, source=0)
    test = gen_log_dataset(rng, 50, source=0)
    batcher = SFTBatcher(train, tok, 160, batch_size=8)

    adapters = init_adapters(cfg, seed=1, device=model.device)
    opt = adamw(lr=3e-3)
    state = opt.init(adapters)
    step = make_lora_train_step(model, cfg, opt)
    losses = []
    for i in range(args.steps):
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in batcher.sample().items()}
        adapters, state, m = step(params, adapters, state, batch)
        losses.append(float(m["loss"]))
        if i % 10 == 0:
            print(f"step {i:3d} loss {losses[-1]:.3f} "
                  f"acc {float(m['accuracy']):.3f}")

    acc = answer_accuracy(model, cfg, params, adapters, test, tok, 160,
                          lora_scale(cfg))
    print(f"answer accuracy (yes/no): {acc:.3f}")

    eng = Engine(model, cfg, params, adapters)
    prompt = np.asarray([tok.encode(test[0].prompt)[:150]], np.int32)
    out = eng.generate(prompt, ServeConfig(batch_size=1, max_new_tokens=4,
                                           cache_len=192))
    print("prompt:", test[0].prompt[:60], "...")
    print("model says:", tok.decode(out[0].cpu().numpy()),
          "| expected:", test[0].answer)
    return {"losses": losses, "accuracy": acc, "tokens": out.cpu()}


if __name__ == "__main__":
    main()
