"""Rank programs of ``tests/test_torch_ssm_mesh.py`` (importable by the
ranks ``launch/mesh.spawn`` starts; no JAX here, so a rank starts
quickly).

:func:`world` runs on every rank of one world: each job makes its
``("pod", "data", "model")`` mesh and runs on this rank's shards and
rows.  The ``"step"`` and ``"round"`` jobs are ``tests/torch_moe_ranks.py``'s
(the LoRA gradient with the data-parallel and model-group sums as the
train step takes them, then one SGD step; ``federated/mesh_job.run`` of
a ``RoundJob``); ``"serve"`` here serves each run through
``MultiTenantEngine.generate`` over ``ServeConfig.mesh``, recording every
slot reset the engine makes on this rank (the local row and whether
every mamba layer's state there reads zero after it), and returns this
rank's first prefill chunk (``launch/serve.first_chunk_logits``: its
rows and vocabulary block) with the bank slot of each client.
``"walks"``, the last job, walks this rank's share of the dry run's
steps the test holds every rank's collective log to (on the meta device:
nothing is issued).
"""
import dataclasses

import torch
import torch.distributed as dist

import torch_moe_ranks as MR
import torch_serve_ranks as SR
from repro_torch.core.partition import mesh_coordinate
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.serve import first_chunk_logits
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import ServeConfig


def _state_rows(cache):
    return cache["layers"][0]["h"].shape[0]


def serve_job(job, mesh):
    runs = []
    for cfg, reqs, kw in job["runs"]:
        eng = SR.build_engine(cfg, job["params"], job["clients"], 4)
        resets = []
        plain = engine_mod.reset_slot

        def recording(cache, slot):
            out = plain(cache, slot)
            resets.append({"row": slot, "rows": _state_rows(out),
                           "zero": all(float(c[k][slot].abs().max()) == 0
                                       for c in out["layers"]
                                       for k in ("h", "conv") if k in c)})
            return out

        engine_mod.reset_slot = recording
        try:
            mesh_lib.reset_collectives()
            streams = eng.generate(SR.requests(reqs),
                                   ServeConfig(mesh=mesh, **kw))
        finally:
            engine_mod.reset_slot = plain
        runs.append({"streams": streams, "stats": eng.last_stats,
                     "resets": resets,
                     "collectives": [dataclasses.asdict(c) for c in
                                     mesh_lib.collectives()]})
    out = {"runs": runs}
    if "first_chunk" in job:
        cfg, reqs, kw = job["first_chunk"]
        eng = SR.build_engine(cfg, job["params"], job["clients"], 4)
        with torch.no_grad():
            logits, n_new = first_chunk_logits(
                eng, SR.requests(reqs), ServeConfig(mesh=mesh, **kw))
        out["first_chunk"] = {"logits": logits, "n_new": n_new,
                              "slots": {c: eng.registry.acquire(c)
                                        for c in job["clients"]}}
    return out


def walks_job(job, mesh):
    """Every ``world``-th of ``job["walks"]`` ((key, cfg, step, rows,
    seq, mesh, options)) from this rank's: each walk's collectives."""
    rank, world = dist.get_rank(), dist.get_world_size()
    return {"walks": {key: dryrun.dry_run(cfg, step, rows, seq, mesh=m,
                                          **kw)["collectives"]
                      for i, (key, cfg, step, rows, seq, m, kw)
                      in enumerate(job["walks"]) if i % world == rank}}


JOBS = dict(MR.JOBS, serve=serve_job, walks=walks_job)


def world(jobs):
    """Every job on this rank, in order; one result dict per job, with
    this rank's mesh coordinate."""
    out = []
    for job in jobs:
        mesh = mesh_lib.make_mesh(*job["mesh"], device="cpu")
        res = JOBS[job["kind"]](job, mesh)
        out.append(dict(res, coord=mesh_coordinate(mesh)))
    return out
