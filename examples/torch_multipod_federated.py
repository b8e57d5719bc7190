"""The multi-pod federated round on the PyTorch port: one FDLoRA round
with the clients on a mesh's "pod" axis, one process per rank, and the
collectives the round issued: its only cross-client traffic is one
all-reduce of the adapter tree's size.

    PYTHONPATH=src python examples/torch_multipod_federated.py --device cpu

Two ranks (``--ranks``), each a process of its own started by
``launch/mesh.spawn`` (gloo on the CPU or on a shared card, NCCL when
every rank has a card), each running the clients of its pod coordinate
through ``federated/mesh_job.run``.  On a card every inner step runs the
``lora_matmul`` and flash-attention kernels.
"""
import argparse

from repro_torch.configs.base import ModelConfig
from repro_torch.federated.mesh_job import Case, RoundJob, run
from repro_torch.launch.mesh import spawn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--compress-outer", default="none",
                    choices=["none", "bf16"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = ModelConfig(name="mp-demo", family="dense", n_layers=2, d_model=128,
                      n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=300,
                      max_seq_len=160, lora_rank=8, dtype="float32",
                      param_dtype="float32")
    K, N, B, S = 3, args.ranks, 4, 128
    job = RoundJob(cfg, [Case(pod=args.ranks, compress=args.compress_outer)],
                   clients=N, inner_steps=K, rows=B, seq=S,
                   device=args.device, return_trees=False)
    ranks = spawn(run, args.ranks, job, device=args.device)
    (res,) = ranks[0]
    print(f"one federated round: {N} clients x {K} inner steps on "
          f"{args.ranks} ranks, loss {res['loss'][0]:.3f}")
    assert all(r[0]["digest"] == res["digest"] for r in ranks), \
        "θ_s' differs across ranks"
    colls = res["collectives"][0]
    for c in colls:
        print(f"  {c['op']} over {c['axis']!r} ({c['group']} ranks): "
              f"{c['bytes']} bytes, {c['per_card_bytes']:.0f} per card by "
              f"the ring")
    adapter_bytes = cfg.count_lora_params() * (
        2 if args.compress_outer == "bf16" else 4)
    print(f"adapter tree: {adapter_bytes / 2**20:.3f} MiB — the round's only "
          f"cross-client traffic is this tree (and {N} losses), once per "
          f"{K}-step round")
    return {"loss": res["loss"][0], "collectives": colls,
            "adapter_bytes": adapter_bytes, "digests": [r[0]["digest"]
                                                        for r in ranks]}


if __name__ == "__main__":
    main()
