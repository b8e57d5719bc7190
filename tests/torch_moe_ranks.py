"""Rank programs of ``tests/test_torch_moe_mesh.py`` (importable by the
ranks ``launch/mesh.spawn`` starts; no JAX here, so a rank starts
quickly).

:func:`world` runs on every rank of one world: each job makes its
``("pod", "data", "model")`` mesh and runs on this rank's shards and
rows, recording every routing decision and dispatch the rank makes
(``moe.RoutingLog``):

* ``"moe"``: ``apply_moe`` alone on a layer's weights and a batch;
* ``"step"``: the LoRA gradient (data-parallel and model-group sums as
  the train step takes them), each rank's own loss, then one SGD train
  step;
* ``"round"``: ``federated/mesh_job.run`` of a :class:`RoundJob`;
* ``"serve"``: ``MultiTenantEngine.generate`` over ``ServeConfig.mesh``
  (``torch_serve_ranks.build_engine``), each run's streams, stats and
  collectives;
* ``"package"``: the package's own rank programs in one
  ``launch/mesh.run_each`` (``launch/serve.mesh_serve`` of a
  ``ServeJob`` and ``federated/mesh_job.run_jobs``), weights drawn from
  a seed, each rank's shard as it is cut.

A dispatch over a data group records whether its capacity binds across
the ranks: whether each rank's own rows, dispatched alone at a capacity
of their own T, would keep other copies than the global dispatch keeps.
"""
import contextlib
import dataclasses

import torch

import torch_serve_ranks as SR
from repro_torch.core.lora import adapter_specs
from repro_torch.core.partition import mesh_coordinate, mesh_shape
from repro_torch.federated.distributed import local_shard
from repro_torch.federated.mesh_job import run as run_round
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import moe
from repro_torch.models import tensor_parallel as tpl
from repro_torch.models.api import Model
from repro_torch.serving.engine import ServeConfig
from repro_torch.training.optimizers import sgd
from repro_torch.training.train_step import (data_parallel_value_and_grad,
                                             global_token_counts,
                                             make_lora_loss_fn,
                                             make_lora_train_step,
                                             model_group_grads,
                                             value_and_grad)


@contextlib.contextmanager
def recording(data: int, factor: float):
    """Record this rank's routing ids and every dispatch
    (``moe.RoutingLog``): (ids, keep, binds across ``data`` ranks), filled
    in when the block ends."""
    rec = {}
    with moe.RoutingLog() as log:
        yield rec
    binds = []
    if data > 1:
        for ids, keep in zip(log.dispatched, log.keep):
            T, k = ids.shape
            E = log.logits[0].shape[-1]
            cap = moe.capacity(T // data, k, E, factor)
            alone = torch.cat([moe.dispatch(b, E, cap)[1]
                               for b in ids.chunk(data)])
            binds.append(not torch.equal(alone, keep))
    rec.update(ids=log.ids, keep=log.keep, binds=binds)


def _rows(t, mesh):
    """This rank's block of ``t``'s rows over "data"."""
    n, d = mesh_shape(mesh)["data"], mesh_coordinate(mesh)["data"]
    w = t.shape[0] // n
    return t[d * w:(d + 1) * w]


def _colls():
    return [dataclasses.asdict(c) for c in mesh_lib.collectives()]


def moe_job(job, mesh):
    cfg = job["cfg"]
    tp, dp = mesh_lib.model_group(mesh), mesh_lib.data_group(mesh)
    p = job["params"]
    if tp is not None:
        p = {k: tpl.shard_leaf(v, moe.moe_specs(cfg.mlp_type)[k], tp.size,
                               tp.rank) for k, v in p.items()}
    mesh_lib.reset_collectives()
    with recording(mesh_shape(mesh)["data"],
                   cfg.moe_capacity_factor) as rec:
        out, aux = moe.apply_moe(p, _rows(job["x"], mesh), cfg, tp=tp, dp=dp)
    return {"out": out, "aux": aux, "collectives": _colls(), **rec}


def step_job(job, mesh):
    cfg, model = job["cfg"], Model(job["cfg"], "cpu")
    tp, dp = mesh_lib.model_group(mesh), mesh_lib.data_group(mesh)
    specs = adapter_specs(cfg)
    pl = local_shard(job["params"], model.param_specs(), mesh)
    al = local_shard(job["adapters"], specs, mesh)
    mine = {k: _rows(v, mesh) for k, v in job["batch"].items()}
    with recording(mesh_shape(mesh)["data"],
                   cfg.moe_capacity_factor) as rec:
        mesh_lib.reset_collectives()
        if dp is None:
            own, metrics, grads = value_and_grad(
                make_lora_loss_fn(model, cfg, tp=tp))(al, pl, mine)
        else:
            denom = global_token_counts([mine], dp.reduce)
            (metrics,), (grads,) = data_parallel_value_and_grad(
                model, cfg, dp.reduce, tp, dp=dp)(pl, [al], [mine], denom)
        if tp is not None:
            (grads,), _ = model_group_grads(
                [grads], tpl.replicated(specs, tp.size), tp)
        colls = _colls()
        if dp is not None:  # this rank's own loss: its share of the whole
            with torch.no_grad():
                own, _ = make_lora_loss_fn(model, cfg, tp=tp, dp=dp)(
                    al, pl, mine, denom[0])
        opt = sgd(job["lr"])
        stepped, _, _ = make_lora_train_step(
            model, cfg, opt, clip_norm=job["clip"], tp=tp, dp=dp)(
                pl, al, opt.init(al), mine)
    return {"metrics": metrics, "grads": grads, "own_loss": own,
            "stepped": stepped, "collectives": colls, **rec}


def round_job(job, mesh):
    with recording(mesh_shape(mesh)["data"],
                   job["round"].cfg.moe_capacity_factor) as rec:
        res = run_round(job["round"])
    return {"rounds": res, **rec}


def serve_job(job, mesh):
    runs = []
    for cfg, reqs, kw in job["runs"]:
        eng = SR.build_engine(cfg, job["params"], job["clients"], 4)
        with recording(mesh_shape(mesh)["data"],
                       cfg.moe_capacity_factor) as rec:
            mesh_lib.reset_collectives()
            streams = eng.generate(SR.requests(reqs),
                                   ServeConfig(mesh=mesh, **kw))
        runs.append({"streams": streams, "stats": eng.last_stats,
                     "collectives": _colls(), **rec})
    return {"runs": runs}


def package_job(job, mesh):
    return {"tasks": mesh_lib.run_each(job["tasks"])}


JOBS = {"moe": moe_job, "step": step_job, "round": round_job,
        "serve": serve_job, "package": package_job}


def world(jobs):
    """Every job on this rank, in order; one result dict per job, with
    this rank's mesh coordinate."""
    out = []
    for job in jobs:
        mesh = mesh_lib.make_mesh(*job["mesh"], device="cpu")
        res = JOBS[job["kind"]](job, mesh)
        out.append(dict(res, coord=mesh_coordinate(mesh)))
    return out
