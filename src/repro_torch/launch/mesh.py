"""The port's device mesh: named ``torch.distributed`` groups over ranks.

Port of ``repro/launch/mesh.py``.  The reference lays jax devices out on a
grid with named axes and lets the compiler place arrays; the port runs one
process per rank and takes its groups from a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
names:

    "pod"    FDLoRA clients (a client is a pod slice, or one card);
    "data"   batch rows inside a client;
    "model"  tensor parallelism inside a client (Megatron-style: heads,
             ff columns and the vocabulary split across its ranks, an
             MoE layer's experts and a mamba layer's SSM heads;
             ``models/tensor_parallel.py``), dense, MoE, SSM and hybrid
             configs.

Single pod: ``("data", "model")`` = (16, 16), 256 ranks.  Multi-pod:
``("pod", "data", "model")`` = (2, 16, 16), 512 ranks.

Every factory works over the running default process group.  With none
running it starts a one-rank group over a ``HashStore`` (no rendezvous,
no port): gloo on the CPU, NCCL on a card.  :func:`spawn` runs an
importable function on N ranks (``spawn`` start method, a ``FileStore``
in a temporary directory).

Spec trees and the helpers that read a mesh's axes are plain data, in
``core/partition.py``.  Collectives go through :func:`all_reduce`, which
logs each one (``analysis/roofline.Collective``); on meta tensors (the
dry run's walk of one rank) it logs and issues nothing.
"""
from __future__ import annotations

import datetime
import math
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.analysis.roofline import Collective, ring_bytes
from repro_torch.core.partition import AXES, mesh_coordinate, mesh_shape
from repro_torch.models.tensor_parallel import DataGroup, ModelGroup

# ---------------------------------------------------------------------------
# Process groups and mesh factories
# ---------------------------------------------------------------------------

def start_group(device="cuda") -> torch.device:
    """The device of this rank's mesh.  If no default process group is
    running, start a one-rank group over a ``HashStore``: gloo on the CPU,
    NCCL on a card (``device`` is the card unless the caller asks for the
    CPU; a missing card raises)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    return dev


def _device_mesh(dev: torch.device, shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=names)


def make_host_mesh(model: int = 1, device="cuda"):
    """``("data", "model")`` over the running group's ranks (started by
    :func:`start_group` if none runs): ``(world // model, model)``."""
    if model < 1:
        raise ValueError(f"model axis must be >= 1, got {model}")
    dev = start_group(device)
    n = dist.get_world_size()
    if n % model != 0:
        raise ValueError(
            f"make_host_mesh(model={model}): {n} ranks are not divisible "
            f"by the model axis; spawn a compatible count with "
            f"launch.mesh.spawn")
    return _device_mesh(dev, (n // model, model), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The reference's production shapes: ``(16, 16)`` over ("data",
    "model"), or ``(2, 16, 16)`` over ("pod", "data", "model"); refused
    with fewer than 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 512 if multi_pod else 256
    dev = start_group(device)
    n = dist.get_world_size()
    if n < need:
        raise ValueError(
            f"make_production_mesh(multi_pod={multi_pod}) needs {need} "
            f"devices, found {n}; use make_host_mesh() for local runs")
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(dev.type, torch.arange(need).reshape(shape),
                      mesh_dim_names=axes)


def make_mesh(pod: int, data: int, model: int = 1, device="cuda"):
    """FDLoRA's ``("pod", "data", "model")`` mesh over the running group's
    ranks.  Refused unless the three sizes multiply to the world size."""
    dev = start_group(device)
    n = dist.get_world_size()
    shape = (pod, data, model)
    if min(shape) < 1 or math.prod(shape) != n:
        raise ValueError(f"mesh {dict(zip(AXES, shape))} does not cover the "
                         f"{n} ranks of the running group")
    return _device_mesh(dev, shape, AXES)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

_LOG: List[Collective] = []


def reset_collectives() -> None:
    _LOG.clear()


def collectives() -> List[Collective]:
    """The collectives this process issued since the last reset."""
    return list(_LOG)


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def all_reduce(t: torch.Tensor, mesh, axis: str,
               op: str = "sum") -> torch.Tensor:
    """Reduce ``t`` in place (``op``: "sum", "max" or "min") over the
    ranks of mesh axis ``axis`` (the group of ranks that differ from this
    one in that coordinate only) and log it.  Returns ``t``.  A meta
    tensor is logged and not reduced: the dry run walks one rank
    (``mesh`` may then be any object :func:`core.partition.mesh_shape`
    reads)."""
    if op not in _OPS:
        raise ValueError(f"unknown reduce op {op!r}; one of {sorted(_OPS)}")
    nbytes = t.numel() * t.element_size()
    if t.is_meta:
        g = mesh_shape(mesh)[axis]
        _LOG.append(Collective("all-reduce", axis, g, nbytes,
                               ring_bytes("all-reduce", nbytes, g)))
        return t
    group = mesh.get_group(axis)
    _sync(t)
    t0 = time.perf_counter()
    dist.all_reduce(t, op=_OPS[op], group=group)
    _sync(t)
    ms = (time.perf_counter() - t0) * 1e3
    g = dist.get_world_size(group)
    _LOG.append(Collective("all-reduce", axis, g, nbytes,
                           ring_bytes("all-reduce", nbytes, g), ms))
    return t


def all_gather(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The tensors ``t`` of every rank of mesh axis ``axis``, stacked in
    coordinate order on a new leading dim: each rank writes its ``t``
    into its row of a zeroed buffer and one sum :func:`all_reduce`
    fills the others' rows (exact: every other rank adds zeros), since
    gloo runs only all-reduce and broadcast on a card's tensors.  Logged
    as that all-reduce."""
    n = mesh_shape(mesh)[axis]
    buf = torch.zeros((n, *t.shape), dtype=t.dtype, device=t.device)
    if not t.is_meta:
        buf[mesh_coordinate(mesh)[axis]] = t
    return all_reduce(buf, mesh, axis)


def model_group(mesh):
    """This rank's ``"model"`` group of ``mesh`` as the models take it
    (``models/tensor_parallel.ModelGroup``): its size, this rank's
    coordinate on the axis, and :func:`all_reduce` over the axis.  None
    at model 1 (or a mesh without the axis): every path then runs as
    with no mesh."""
    size = mesh_shape(mesh).get("model", 1)
    if size == 1:
        return None
    return ModelGroup(size, mesh_coordinate(mesh)["model"],
                      lambda t, op="sum": all_reduce(t, mesh, "model", op))


def data_group(mesh, axes=("data",)):
    """This rank's data group of ``mesh`` as the models take it
    (``models/tensor_parallel.DataGroup``): the ranks that differ from
    this one in ``axes`` (the first major, as :func:`federated.
    distributed.local_shard` lays rows out), this rank's place among
    them, :func:`all_gather` (minor axis first, so the rows come back in
    flat order) and :func:`all_reduce` over them.  None where those axes
    are all of size 1 (or absent): every path then runs as with no
    mesh."""
    sizes, coord = mesh_shape(mesh), mesh_coordinate(mesh)
    axes = tuple(a for a in axes if sizes.get(a, 1) > 1)
    if not axes:
        return None
    size, rank = 1, 0
    for a in axes:
        size, rank = size * sizes[a], rank * sizes[a] + coord[a]

    def gather(t):
        for a in reversed(axes):
            t = all_gather(t, mesh, a).reshape(-1, *t.shape[1:])
        return t

    def reduce(t, op="sum"):
        for a in axes:
            all_reduce(t, mesh, a, op)
        return t

    return DataGroup(size, rank, gather, reduce)


# ---------------------------------------------------------------------------
# Running a function on N ranks
# ---------------------------------------------------------------------------

def run_each(tasks: Sequence[Tuple[Callable, tuple]]) -> List[Any]:
    """``[fn(*args) for fn, args in tasks]``: several rank programs, each
    an importable function, in one :func:`spawn`."""
    return [fn(*args) for fn, args in tasks]


def to_cpu(tree):
    """``tree`` (dicts, lists, tuples) with every tensor moved to the
    CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
    return tree


SPAWN_TIMEOUT_S = 600.0     # a rank that outlives it stops every rank


def _rank_main(fn, rank: int, world: int, workdir: str, backend: str,
               device: str, args) -> None:
    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        else:
            torch.set_num_threads(1)
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(workdir, "store"),
                                          world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=SPAWN_TIMEOUT_S))
        out = fn(*args)
        with open(os.path.join(workdir, f"out{rank}.pkl"), "wb") as f:
            pickle.dump(to_cpu(out), f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(workdir, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(fn: Callable, world: int, *args, device="cuda") -> List[Any]:
    """Run ``fn(*args)`` on ``world`` ranks, each a process started by the
    ``spawn`` method (so no CUDA state is forked) in a default process
    group over a ``FileStore`` in a temporary directory; return each
    rank's result, moved to the CPU, in rank order.  ``fn`` must be
    importable (a module-level function of the package).  The backend is
    NCCL when every rank has a card of its own, else gloo (ranks that
    share a card, or the CPU, where each rank runs one torch thread).  A
    rank that fails or outlives ``SPAWN_TIMEOUT_S`` stops every rank, and
    the call raises with its traceback."""
    import multiprocessing as mp
    dev = resolve_device(device)
    backend = ("nccl" if dev.type == "cuda"
               and world <= torch.cuda.device_count() else "gloo")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="mesh-") as workdir:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, workdir, backend, dev.type,
                                   args))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        try:    # until every rank is done, one has failed, or time is up
            while (any(p.is_alive() for p in procs)
                   and not any(p.exitcode for p in procs)
                   and time.monotonic() < deadline):
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:     # a rank that raised, before the ranks killed after it
            errs = [os.path.join(workdir, f"err{r}.txt") for r in bad]
            r, err = next(((r, e) for r, e in zip(bad, errs)
                           if os.path.exists(e)), (bad[0], None))
            why = (open(err).read() if err
                   else f"killed after {SPAWN_TIMEOUT_S} s or by a "
                   "signal")
            raise RuntimeError(f"rank {r} of {world} failed (exit "
                               f"{procs[r].exitcode}):\n{why}")
        out = []
        for r in range(world):
            with open(os.path.join(workdir, f"out{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out

