"""An FDLoRA round job on the ranks of a mesh, and what each rank returns.

:func:`run` is the program every rank runs: through ``launch/mesh.spawn``
on N ranks, or in the caller's process at world size 1.  It builds the
model and data of a :class:`RoundJob` (random weights and SFT rows of
synthetic log text from its seed, or the trees it carries), then for each
:class:`Case` makes the mesh, takes this rank's shards
(``federated/distributed.local_shard``: at ``"model"`` > 1 of the base
and θ_s too), runs ``rounds`` rounds of
``make_fdlora_round_step`` and returns θ_s', this rank's state shard, the
losses, the collectives issued, the kernels' launches, the seconds per
round and the peak memory (and, for an MoE model, the LoRA loss and its
aux metric at θ_s', :func:`objective`).  The tests, ``examples/
torch_multipod_federated.py`` and ``chip_smoke.py`` share it, so every
rank program is importable from the package (``spawn`` needs that).
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import kernels, resolve_device
from repro_torch.core.lora import (adapter_specs, init_adapters, tree_leaves,
                                   tree_map)
from repro_torch.core.outer_opt import make_outer_optimizer
from repro_torch.core.partition import mesh_coordinate
from repro_torch.federated.distributed import (batch_specs, client_slice,
                                               local_shard,
                                               make_fdlora_round_step,
                                               stack_clients, state_specs)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.api import Model
from repro_torch.training.optimizers import adamw
from repro_torch.training.train_step import (global_token_counts,
                                             make_lora_loss_fn)


@dataclasses.dataclass(frozen=True)
class Case:
    """One round configuration: ``pod`` None is the meshless round (every
    client on this rank, no collective); else the ``("pod", "data",
    "model")`` sizes of the mesh, which must cover the world."""
    pod: Optional[int] = 1
    data: int = 1
    model: int = 1
    compress: str = "none"
    sync: bool = False


@dataclasses.dataclass
class RoundJob:
    cfg: Any                          # the port's ModelConfig
    cases: Sequence[Case]
    clients: int = 2
    inner_steps: int = 2              # K
    rows: int = 8                     # B, per client and step
    seq: int = 256                    # S
    rounds: int = 1
    inner_lr: float = 2e-4            # AdamW, weight decay 0.01
    outer_lr: float = 1e-3            # Nesterov
    outer_momentum: float = 0.5
    seed: int = 0
    params: Any = None                # CPU tree; None: Model.init(seed)
    theta: Any = None                 # CPU tree; None: seeded, B non-zero
    batches: Optional[List[Dict[str, np.ndarray]]] = None  # per round
    device: str = "cuda"
    return_trees: bool = True         # else digests only


def sft_batches(job: RoundJob) -> List[Dict[str, np.ndarray]]:
    """Per round, ``tokens`` and ``loss_mask`` (N, K, B, S) int32: SFT
    rows of synthetic log text (a dataset per client from ``job.seed``),
    the prompt masked out of the loss, so masks differ row to row; a
    VLM's ``patch_embeds`` (N, K, B, n_patch_tokens, d) and an
    encoder-decoder's ``enc_embeds`` (N, K, B, encoder_seq_len, d), fp32
    stubs of the modality frontend drawn from ``job.seed + 1`` (patches
    at the embedding table's scale 0.02, frames at unit scale, as a conv
    frontend's output)."""
    from repro_torch.data.pipeline import SFTBatcher
    from repro_torch.data.synthetic import gen_log_dataset
    from repro_torch.data.tokenizer import ByteTokenizer
    rng = np.random.default_rng(job.seed)
    batchers = [SFTBatcher(gen_log_dataset(rng, 64, i), ByteTokenizer(),
                           job.seq, job.rows, seed=i)
                for i in range(job.clients)]
    out = []
    for _ in range(job.rounds):
        raw = [[b.sample() for _ in range(job.inner_steps)]
               for b in batchers]
        out.append({k: np.stack([np.stack([s[k] for s in row])
                                 for row in raw]).astype(np.int32)
                    for k in ("tokens", "loss_mask")})
        out[-1]["tokens"] %= job.cfg.vocab_size
    cfg = job.cfg
    stub = {"vlm": ("patch_embeds", cfg.n_patch_tokens, 0.02),
            "encdec": ("enc_embeds", cfg.encoder_seq_len, 1.0)}
    if cfg.family in stub:
        key, n, scale = stub[cfg.family]
        frontend = np.random.default_rng(job.seed + 1)
        for b in out:
            b[key] = (frontend.standard_normal(
                (job.clients, job.inner_steps, job.rows, n, cfg.d_model),
                dtype=np.float32) * scale)
    return out


def digest(tree) -> str:
    """sha256 over every leaf's bytes in ``tree_leaves`` order."""
    h = hashlib.sha256()
    for path, leaf in tree_leaves(tree):
        h.update(path.encode())
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().contiguous().view(torch.uint8).numpy()
        h.update(np.ascontiguousarray(np.asarray(leaf)).tobytes())
    return h.hexdigest()


def client_digests(state: Dict) -> List[str]:
    """Per client of a stacked state (this rank's shard): the digest of
    its inner optimizer state and, when synced, its personalized tree."""
    n = len(state["inner_opt"]["count"])
    return [digest({k: client_slice(state[k], i)
                    for k in ("inner_opt", "personalized") if k in state})
            for i in range(n)]


def _on(tree, dev):
    return tree_map(lambda t: torch.as_tensor(t).to(dev), tree)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def objective(model, cfg, base, theta, batch, mesh=None) -> Dict:
    """The round's LoRA loss (``training/train_step.make_lora_loss_fn``:
    the cross entropy plus ``router_aux_loss_coef`` times the aux loss,
    each rank's share of it as the round differentiates it) and its
    ``aux_loss`` metric, of one client's first step batch (``batch``:
    this rank's (n, K, B, S) rows) at adapters ``theta``, on this rank's
    shards and rows of ``mesh``.  At ``"data"`` > 1 the ranks' shares of
    the loss are summed over the data group: the whole batch's, where the
    aux term counts once."""
    tp = dp = None
    if mesh is not None:
        tp, dp = mesh_lib.model_group(mesh), mesh_lib.data_group(mesh)
    first = {k: v[0, 0] for k, v in batch.items()}
    loss_fn = make_lora_loss_fn(model, cfg, tp=tp, dp=dp)
    with torch.no_grad():
        denom = (None if dp is None
                 else global_token_counts([first], dp.reduce)[0])
        loss, metrics = loss_fn(theta, base, first, denom)
        if dp is not None:
            loss = dp.reduce(loss.float().reshape(1))[0]
    return {"objective": float(loss), "aux_loss": float(metrics["aux_loss"])}


def run(job: RoundJob) -> List[Dict]:
    """Every case of ``job`` on this rank; one result dict per case.  At
    ``"model"`` > 1 a case runs on this rank's shard of the base (the
    whole base is dropped once no case of the job needs it, before any
    round, so the peak holds the shard only; where every case runs on one
    such mesh and the job carries no weights, the shard is drawn as it is
    cut, ``Model.init(shard=)``, and the base is never held whole) and
    returns its shards of θ_s' and the state."""
    dev = resolve_device(job.device)
    cfg = job.cfg
    model = Model(cfg, dev)
    theta0 = (init_adapters(cfg, seed=job.seed + 120, device=dev,
                            b_std=0.02)
              if job.theta is None else _on(job.theta, dev))
    rounds = job.batches if job.batches is not None else sft_batches(job)
    inner = adamw(lr=job.inner_lr, weight_decay=0.01)
    outer = make_outer_optimizer("nesterov", job.outer_lr, job.outer_momentum)
    specs = adapter_specs(cfg)
    meshes: Dict[tuple, Any] = {}
    bases: Dict[tuple, Any] = {}
    for case in job.cases:
        if case.pod is not None:
            shape = (case.pod, case.data, case.model)
            if shape not in meshes:
                meshes[shape] = mesh_lib.make_mesh(*shape, device=dev)
    sharded = all(c.pod is not None and c.model > 1 for c in job.cases)
    params = None
    if sharded and job.params is None and len(meshes) == 1:
        ((shape, mesh),) = meshes.items()
        bases[shape] = model.init(job.seed, shard=(
            shape[2], mesh_coordinate(mesh)["model"]))
    else:
        params = (model.init(job.seed) if job.params is None
                  else _on(job.params, dev))
        for shape, mesh in meshes.items():
            if shape[2] > 1:          # copies: a row block is a view
                bases[shape] = tree_map(
                    lambda t: t.clone(),
                    local_shard(params, model.param_specs(), mesh))
    if sharded:
        params = None
        gc.collect()
    results = []
    for case in job.cases:
        mesh = None
        if case.pod is not None:
            mesh = meshes[(case.pod, case.data, case.model)]
        base = bases.get((case.pod, case.data, case.model), params)
        step = make_fdlora_round_step(
            model, cfg, inner, outer, job.inner_steps,
            sync_personalized=case.sync, compress_outer=case.compress,
            mesh=mesh)
        theta = theta0
        state = {"inner_opt": stack_clients([inner.init(theta)]
                                            * job.clients),
                 "outer_opt": outer.init(theta)}
        if mesh is not None:
            state = local_shard(state, state_specs(specs, state), mesh)
            if case.model > 1:
                theta = local_shard(theta, specs, mesh)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        rec = {"case": dataclasses.asdict(case), "clients": job.clients,
               "coord": ({} if mesh is None
                         else mesh_coordinate(mesh)),
               "loss": [], "seconds": [], "collectives": []}
        for raw in rounds:
            batch = {k: torch.as_tensor(v) for k, v in raw.items()}
            if mesh is not None:
                batch = local_shard(batch, {k: batch_specs() for k in batch},
                                    mesh)
            batch = _on(batch, dev)
            kernels.reset_launch_counts()
            mesh_lib.reset_collectives()
            _sync(dev)
            t0 = time.perf_counter()
            theta, state, loss = step(base, theta, state, batch)
            _sync(dev)
            rec["seconds"].append(time.perf_counter() - t0)
            rec["loss"].append(float(loss))
            rec["collectives"].append(
                [dataclasses.asdict(c) for c in mesh_lib.collectives()])
        rec.update(launches=kernels.launch_counts(),
                   tiles=kernels.tile_counts(),
                   **(objective(model, cfg, base, theta, batch, mesh)
                      if cfg.has_moe() else {}),
                   digest=digest(theta),
                   client_digests=client_digests(state),
                   outer_digest=digest(state["outer_opt"]),
                   peak_bytes=(torch.cuda.max_memory_allocated(dev)
                               if dev.type == "cuda" else 0))
        if job.return_trees:
            rec.update(theta=theta, state=state)
        results.append(rec)
        del theta, state, step, base
    del params, model, theta0, bases
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return results


def run_jobs(jobs: Sequence[RoundJob]) -> List[List[Dict]]:
    """:func:`run` for each job in turn (one spawn serves several)."""
    return [run(job) for job in jobs]
