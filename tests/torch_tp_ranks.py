"""Rank programs of ``tests/test_torch_tensor_parallel.py`` (importable by
the ranks ``launch/mesh.spawn`` starts; no JAX here, so a rank starts
quickly).

:func:`world2` runs on each of two ranks: the FDLoRA round jobs
(``federated/mesh_job.run_jobs``), then on a ``(1, 1, 2)`` mesh one
forward, one LoRA gradient and one train step of the given trees, each
rank on its shards.  :func:`world4` runs on each of four: the round jobs,
then one train step on a ``(1, 2, 2)`` mesh."""
import dataclasses

import torch

from repro_torch.core.lora import adapter_specs, lora_scale
from repro_torch.federated.distributed import local_shard
from repro_torch.federated.mesh_job import run_jobs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import tensor_parallel as tpl
from repro_torch.models.api import Model
from repro_torch.models.model import param_specs
from repro_torch.training.optimizers import sgd
from repro_torch.training.train_step import (make_lora_loss_fn,
                                             make_lora_train_step,
                                             model_group_grads,
                                             value_and_grad)


def step_checks(cfg, params, adapters, batch, lr: float, clip: float):
    """This rank's logits block, loss, metrics, gradient shards (the
    replicated leaves summed), the global gradient norm, the adapters
    after one SGD step clipped at ``clip``, and the collectives of the
    gradient."""
    mesh = mesh_lib.make_mesh(1, 1, 2, device="cpu")
    tp = mesh_lib.model_group(mesh)
    model = Model(cfg, "cpu")
    specs = adapter_specs(cfg)
    pl = local_shard(params, param_specs(cfg), mesh)
    al = local_shard(adapters, specs, mesh)
    with torch.no_grad():
        logits, _ = model.forward(pl, batch, adapters=al,
                                  lora_scale=lora_scale(cfg), tp=tp)
    mesh_lib.reset_collectives()
    vg = value_and_grad(make_lora_loss_fn(model, cfg, tp=tp))
    loss, metrics, grads = vg(al, pl, batch)
    (grads,), norms = model_group_grads([grads], tpl.replicated(specs), tp)
    colls = [dataclasses.asdict(c) for c in mesh_lib.collectives()]
    opt = sgd(lr)
    step = make_lora_train_step(model, cfg, opt, clip_norm=clip, tp=tp)
    stepped, _, _ = step(pl, al, opt.init(al), batch)
    return {"coord": mesh_lib.mesh_coordinate(mesh), "logits": logits,
            "loss": loss, "metrics": metrics, "grads": grads,
            "norm": norms[0], "stepped": stepped, "collectives": colls}


def world2(round_jobs, step_args):
    return {"rounds": run_jobs(round_jobs), "step": step_checks(**step_args)}


def data_model_step(cfg, params, adapters, batch, lr: float, clip: float):
    """One SGD train step clipped at ``clip`` on a ``(1, 2, 2)`` mesh:
    each data rank on its half of ``batch``'s rows, each model rank on
    its shards.  Returns this rank's coordinate, metrics, stepped shards
    and the step's collectives."""
    mesh = mesh_lib.make_mesh(1, 2, 2, device="cpu")
    coord = mesh_lib.mesh_coordinate(mesh)
    rows = next(iter(batch.values())).shape[0] // 2
    mine = {k: v[coord["data"] * rows:(coord["data"] + 1) * rows]
            for k, v in batch.items()}
    model = Model(cfg, "cpu")
    pl = local_shard(params, param_specs(cfg), mesh)
    al = local_shard(adapters, adapter_specs(cfg), mesh)
    opt = sgd(lr)
    step = make_lora_train_step(
        model, cfg, opt, clip_norm=clip, tp=mesh_lib.model_group(mesh),
        reduce_data=lambda t: mesh_lib.all_reduce(t, mesh, "data"))
    mesh_lib.reset_collectives()
    stepped, _, metrics = step(pl, al, opt.init(al), mine)
    return {"coord": coord, "metrics": metrics, "stepped": stepped,
            "collectives": [dataclasses.asdict(c)
                            for c in mesh_lib.collectives()]}


def world4(round_jobs, step_args):
    return {"rounds": run_jobs(round_jobs),
            "step": data_model_step(**step_args)}
