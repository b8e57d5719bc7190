"""Rank programs of ``tests/test_torch_vlm_encdec_mesh.py`` (importable by
the ranks ``launch/mesh.spawn`` starts; no JAX here, so a rank starts
quickly).

:func:`world` runs on every rank of one world: each job makes its
``("pod", "data", "model")`` mesh and runs on this rank's shards and
rows.  The ``"step"``, ``"round"`` and ``"serve"`` jobs are
``tests/torch_moe_ranks.py``'s (the LoRA gradient with the model-group
sums as the train step takes them, then one SGD step;
``federated/mesh_job.run`` of a ``RoundJob``; streams through
``MultiTenantEngine.generate`` over ``ServeConfig.mesh``), ``"walks"``
is ``tests/torch_ssm_ranks.py``'s (this rank's share of the dry run's
walks, made last).  ``"decode"`` here runs
the encoder-decoder's fixed path on this rank's shards: ``prefill_cross``
into a cache at the rank's kv heads, a forward over the first tokens and
its greedy sample (the dry run's prefill), then greedy ``decode_step``
calls,
each step's token taken as every rank takes it (the dry run's greedy
sample: a reduce over "model" where it splits the vocabulary, the plain
argmax of the whole logits where it does not), with the collectives of
the prefill and of each step.
"""
import dataclasses

import torch

import torch_moe_ranks as MR
import torch_ssm_ranks as SSM
from repro_torch.core.lora import adapter_specs, lora_scale
from repro_torch.core.partition import mesh_coordinate
from repro_torch.federated.distributed import local_shard
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import encdec
from repro_torch.models.api import Model


def _colls():
    return [dataclasses.asdict(c) for c in mesh_lib.collectives()]


def decode_job(job, mesh):
    cfg = job["cfg"]
    tp = mesh_lib.model_group(mesh)
    model = Model(cfg, "cpu")
    params = local_shard(job["params"], model.param_specs(), mesh)
    ad = local_shard(job["adapters"], adapter_specs(cfg), mesh)
    scale = lora_scale(cfg)
    tok = job["first"]
    with torch.no_grad():
        cache = model.init_decode_cache(tok.shape[0], job["steps"], tp=tp)
        mesh_lib.reset_collectives()
        cache["cross_k"], cache["cross_v"] = encdec.prefill_cross(
            params, job["enc"], cfg, ad, scale, tp=tp)
        prefill = _colls()
        cross = (cache["cross_k"].clone(), cache["cross_v"].clone())
        mesh_lib.reset_collectives()
        logits, _ = model.forward(params, {"enc_embeds": job["enc"],
                                           "tokens": tok}, adapters=ad,
                                  lora_scale=scale, tp=tp)
        dryrun.greedy_tokens(cfg, logits, mesh, tp, ())
        forward = _colls()
        toks, steps = [tok], []
        for t in range(job["steps"]):
            mesh_lib.reset_collectives()
            logits, cache = model.decode_step(params, cache, tok, t,
                                              adapters=ad, lora_scale=scale,
                                              tp=tp)
            tok = dryrun.greedy_tokens(cfg, logits, mesh, tp, ())[:, None]
            steps.append(_colls())
            toks.append(tok)
    return {"tokens": torch.cat(toks, 1), "cross": cross,
            "vocab_columns": logits.shape[-1], "prefill_collectives": prefill,
            "forward_collectives": forward, "step_collectives": steps}


JOBS = dict(MR.JOBS, walks=SSM.walks_job, decode=decode_job)


def world(jobs):
    """Every job on this rank, in order; one result dict per job, with
    this rank's mesh coordinate."""
    out = []
    for job in jobs:
        mesh = mesh_lib.make_mesh(*job["mesh"], device="cpu")
        res = JOBS[job["kind"]](job, mesh)
        out.append(dict(res, coord=mesh_coordinate(mesh)))
    return out
