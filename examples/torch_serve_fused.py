"""Serving demo on the PyTorch/CUDA port: batched decoding with an
AdaFusion-merged dual LoRA, plus the fused dual-LoRA kernel on the same
weights.

    PYTHONPATH=src python examples/torch_serve_fused.py [--device cuda]

On a card the decode steps run the ``lora_matmul`` kernel at every
projection and the last check runs ``dual_lora_matmul``, which merges
Eq. 7 on the chip; ``--device cpu`` runs their plain versions.  The two
pairs draw a non-zero B, so the merge is not trivially zero.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dual_lora import merge
from repro_torch.core.lora import init_adapters, lora_scale
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.kernels.ops import fused_dual_lora_dense
from repro_torch.models.api import Model
from repro_torch.serving.engine import Engine, ServeConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = ModelConfig(name="serve-demo", family="dense", n_layers=2,
                      d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                      vocab_size=300, max_seq_len=128, lora_rank=8,
                      dtype="float32", param_dtype="float32")
    model = Model(cfg, args.device)
    dev = model.device
    params = model.init(0)
    tok = ByteTokenizer()

    # two adapter sets standing in for a client's personalized + global LoRA
    ad_p = init_adapters(cfg, seed=1, device=dev, b_std=0.02)
    ad_s = init_adapters(cfg, seed=2, device=dev, b_std=0.02)
    w = torch.tensor([0.7, 0.5], device=dev)
    fused = merge(ad_p, ad_s, w)

    eng = Engine(model, cfg, params, adapters=fused)
    prompts = ["logs: job start | net link up anomaly? ",
               "logs: kernel panic cpu0 | fan speed set anomaly? "]
    rows = [tok.encode(p)[:48] for p in prompts]
    batch = np.asarray([r + [0] * (48 - len(r)) for r in rows], np.int32)
    out = eng.generate(batch, ServeConfig(batch_size=2, max_new_tokens=4,
                                          cache_len=128))
    for p, o in zip(prompts, out.cpu().numpy()):
        print(f"prompt: {p!r}\n  -> {tok.decode(o)!r}")

    # the same math through the fused dual-LoRA kernel (Eq. 7 merged on
    # the chip)
    print("\ndual-LoRA kernel vs the merged pair (wq of layer 0):")
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((4, cfg.d_model), generator=g, device=dev
                    ).to(torch.bfloat16)
    wq = params["layers"][0]["mixer"]["wq"].to(torch.bfloat16)
    lp = ad_p["layers"][0]["mixer"]["wq"]
    ls = ad_s["layers"][0]["mixer"]["wq"]
    y_kernel = fused_dual_lora_dense(x, wq, lp, ls, w, lora_scale(cfg))
    fq = fused["layers"][0]["mixer"]["wq"]
    y_ref = (x @ wq).float() + lora_scale(cfg) * (x.float() @ fq["a"]
                                                  @ fq["b"])
    err = float((y_kernel.float() - y_ref).abs().max())
    print(f"  max |kernel - reference| = {err:.5f}")
    return {"tokens": out.cpu(), "kernel_err": err,
            "max_abs_ref": float(y_ref.abs().max())}


if __name__ == "__main__":
    main()
