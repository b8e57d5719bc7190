"""Rank programs of ``tests/test_torch_mesh_serve.py`` (importable by the
ranks ``launch/mesh.spawn`` starts; no JAX here, so a rank starts
quickly).

:func:`serve_jobs` runs on every rank of one world: for each job it makes
the job's ``("pod", "data", "model")`` mesh, builds the engine from the
trees the job carries (the same on every rank), serves each of the job's
runs through ``MultiTenantEngine.generate`` with ``ServeConfig(mesh=)``,
and returns the streams, the stats and the collectives of each run; a job
with ``logits`` also returns this rank's block of a prefill chunk's and a
decode step's logits."""
import dataclasses

import numpy as np
import torch

from repro_torch.core.partition import mesh_coordinate
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.api import Model
from repro_torch.serving.engine import MultiTenantEngine, Request, ServeConfig
from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.serving.registry import AdapterRegistry


def build_engine(cfg, params, clients, capacity, registry_kw=None):
    """The engine on the CPU: ``params`` (the port's tree), ``clients``
    {client id: adapter tree} registered in order."""
    reg = AdapterRegistry(cfg, capacity=capacity, device="cpu",
                          **(registry_kw or {}))
    for cid, tree in clients.items():
        reg.register(cid, tree)
    return MultiTenantEngine(Model(cfg, "cpu"), cfg, params, reg)


def requests(reqs):
    return [Request(c, np.asarray(p, np.int32), max_new_tokens=b)
            for c, p, b in reqs]


def chunk_inputs(reqs, block_size):
    """One prefill chunk holding every request's whole prompt on a fresh
    pool, all slots admitted: tokens (B, T), n_new (B,), block tables and
    lengths (int32 numpy), and the pool's block count; each slot's blocks
    also hold one decode step after the chunk."""
    B = len(reqs)
    T = max(len(p) for _, p, _ in reqs)
    per = -(-(T + 1) // block_size)
    kv = PagedKVCache(B, block_size, 1 + B * per, per)
    tokens = np.zeros((B, T), np.int32)
    n_new = np.zeros((B,), np.int32)
    for i, (_, p, _) in enumerate(reqs):
        kv.admit(i)
        kv.ensure(i, len(p) + 1)
        tokens[i, :len(p)] = p
        n_new[i] = len(p)
    return tokens, n_new, kv.block_tables.copy(), kv.lengths.copy(), \
        1 + B * per


def first_logits(eng, reqs, sc, decode_tokens):
    """This rank's vocabulary block of the logits of :func:`chunk_inputs`'
    prefill chunk and of one decode step after it feeding
    ``decode_tokens`` (B,): (B, T, V / size), (B, 1, V / size).  Every
    row on this rank: a mesh whose "data" axis is 1."""
    tokens, n_new, bt, lens, nb = chunk_inputs(reqs, sc.block_size)
    tp = mesh_lib.model_group(sc.mesh)
    ids = torch.tensor([eng.registry.acquire(c) for c, _, _ in reqs],
                       dtype=torch.int32)
    cache = eng.model.init_paged_decode_cache(nb, sc.block_size,
                                              kv_dtype=sc.kv_dtype, tp=tp)
    kw = dict(adapters=eng.bank_for(sc), lora_scale=eng.scale,
              adapter_ids=ids, block_tables=torch.from_numpy(bt), tp=tp)
    params = eng.params_for(sc)
    pre, cache = eng.model.prefill_step(
        params, cache, torch.from_numpy(tokens), torch.from_numpy(lens),
        torch.from_numpy(n_new), **kw)
    dec, _ = eng.model.decode_step(
        params, cache, torch.as_tensor(decode_tokens,
                                       dtype=torch.int32)[:, None],
        torch.from_numpy(lens + n_new), **kw)
    return pre, dec


def serve_jobs(jobs):
    """Every job on this rank; one result dict per job."""
    out = []
    for job in jobs:
        mesh = mesh_lib.make_mesh(*job["mesh"], device="cpu")
        eng = build_engine(job["cfg"], job["params"], job["clients"],
                           job["capacity"], job.get("registry_kw"))
        runs = []
        for reqs, kw in job["runs"]:
            sc = ServeConfig(mesh=mesh, **kw)
            mesh_lib.reset_collectives()
            streams = eng.generate(requests(reqs), sc)
            runs.append({"streams": streams, "stats": eng.last_stats,
                         "collectives": [dataclasses.asdict(c) for c in
                                         mesh_lib.collectives()]})
        res = {"coord": mesh_coordinate(mesh), "runs": runs}
        if "logits" in job:
            reqs, kw, dec = job["logits"]
            sc = ServeConfig(mesh=mesh, **kw)
            res["logits"] = first_logits(eng, reqs, sc, dec)
        out.append(res)
    return out
