"""End-to-end FDLoRA on the PyTorch/CUDA port: N ISP-like clients with
non-IID log data run Algorithm 1 (local learning -> federated dual-LoRA
-> AdaFusion) and report per-client accuracy and communication.

    PYTHONPATH=src python examples/torch_federated_log_analysis.py              # demo
    PYTHONPATH=src python examples/torch_federated_log_analysis.py --preset 100m
      (the ~100M-parameter preset; same code path)

On a card (``--device cuda``, the default) every train step runs the
``lora_matmul`` and flash-attention kernels and every AdaFusion
evaluation ``dual_lora_matmul``; ``--device cpu`` runs their plain
versions.
"""
import argparse

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.fdlora import FDLoRAConfig, FDLoRATrainer
from repro_torch.core.lora import lora_scale
from repro_torch.data.partition import dirichlet_partition, train_test_split
from repro_torch.data.pipeline import SFTBatcher
from repro_torch.data.synthetic import answer_accuracy, gen_log_dataset
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models.api import Model

PRESETS = {
    "tiny": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256),
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                 d_ff=2048),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=list(PRESETS))
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = ModelConfig(name=f"fdlora-{args.preset}", family="dense",
                      vocab_size=300, max_seq_len=192, lora_rank=8,
                      dtype="float32", param_dtype="float32",
                      **PRESETS[args.preset])
    model = Model(cfg, args.device)
    params = model.init(0)
    print(f"backbone: {cfg.count_params()/1e6:.1f}M params "
          f"(LoRA trains {cfg.count_lora_params()/1e3:.1f}K = "
          f"{100*cfg.count_lora_params()/cfg.count_params():.3f}%)")

    rng = np.random.default_rng(0)
    tok = ByteTokenizer()
    data = sum((gen_log_dataset(rng, 150, s) for s in range(3)), [])
    parts = dirichlet_partition(data, args.clients, args.alpha, rng)
    batchers, tests = [], []
    for i, p in enumerate(parts):
        tr, te = train_test_split(p, 0.2, rng)
        batchers.append(SFTBatcher(tr, tok, 160, batch_size=8, seed=i))
        tests.append(te)
        print(f"client {i}: {len(tr)} train / {len(te)} test")

    fed = FDLoRAConfig(n_clients=args.clients, rounds=args.rounds,
                       inner_steps=3, sync_every=max(args.rounds // 2, 1),
                       stage1_steps=15, inner_lr=3e-3, fusion_steps=5,
                       few_shot_k=8)
    trainer = FDLoRATrainer(model, cfg, fed, params, device=model.device)

    print("\n== Stage 1: local learning (personalized LoRA) ==")
    clients = trainer.stage1(batchers)
    print("global LoRA initialised to client mean (Eq. 6)")

    print("\n== Stage 2: federated dual-LoRA ==")
    trainer.stage2(clients, batchers)
    for h in trainer.history[-3:]:
        print(f"round {h['round']}: inner loss {h['loss']:.3f}")

    print("\n== Stage 3: AdaFusion ==")
    trainer.stage3(clients, batchers)
    for i, c in enumerate(clients):
        print(f"client {i}: fusion weights w=({c.fusion_weights[0]:.2f}, "
              f"{c.fusion_weights[1]:.2f})")

    print("\n== Evaluation ==")
    result = []
    for i, c in enumerate(clients):
        fused = trainer.fused_adapters(c)
        acc = answer_accuracy(model, cfg, params, fused, tests[i], tok, 160,
                              lora_scale(cfg))
        mb = (c.comm_bytes_up + c.comm_bytes_down) / 2**20
        print(f"client {i}: accuracy {acc:.3f}  communicated {mb:.2f} MiB")
        result.append({"accuracy": acc, "comm_mib": mb,
                       "fusion_weights": [float(v) for v in
                                          c.fusion_weights]})
    return result


if __name__ == "__main__":
    main()
