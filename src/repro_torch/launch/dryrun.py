"""Dry run on the meta device: what an arch × shape step needs on one card,
and what bounds it.

Port of ``repro/launch/dryrun.py`` for one H100.  The reference lowers
and compiles each step for hundreds of placeholder TPU devices and reads
the compiler's memory and cost analyses; the port has no compiler to ask,
so it runs the same four steps on ``torch.device("meta")`` along the
card's path (``paged_backend="cuda"``), where every kernel wrapper takes
its meta route (``kernels/meta.py``: empty outputs of the launch's
shapes, the launch's FLOPs, bytes and scratch recorded) and no plain-path
attention scores are formed in a forward.  Nothing is allocated and
nothing is computed; every layer is visited once, so no depth is
extrapolated.

Per step the result JSON holds:

* ``memory.argument_bytes``: the bytes of every tensor the step takes
  (parameters, adapters, optimizer state, decode cache, inputs), exact;
* ``memory.peak_bytes`` / ``temp_bytes``: the arguments plus the peak of
  the storages the step holds live at once (tallied by :class:`Tally`, a
  ``TorchDispatchMode``, as storages are made and freed), plus the scratch
  of the kernel running at that moment; ``output_bytes`` what the step
  returns;
* ``roofline``: ``analysis/roofline.analyze`` of the FLOPs
  (``FlopCounterMode`` over the plain ops, plus the kernels' recorded
  FLOPs) and HBM bytes (every plain op's operand and result bytes, an
  unfused upper bound, plus the kernels' recorded bytes);
* ``kernels``: launches, FLOPs, bytes and the largest scratch of each
  kernel; ``device``: the card's name and memory.

Over a mesh (``dry_run(..., mesh=(pod, data, model))``, the CLI's
``--mesh P,D,M``; ``--mesh 2,16,16`` is the reference's multi-pod mesh)
the walk is one rank's
step at its local shard shapes (``models/tensor_parallel.local_config``:
heads, ff columns and the vocabulary over "model", a vocabulary the axis
does not divide whole on every rank, as the reference's ``_shardings``
lays it out; batch rows over "pod" and "data"): ``memory`` is per rank,
every collective the step issues is logged by ``launch/mesh.all_reduce``
instead of issued (``collectives``: each one's axis, group and bytes),
and the roofline takes ``chips`` and that log.  All four steps walk
there, for every family (the VLM's patch embeddings whole on every rank;
the encoder-decoder's encoder, decoder and cross K/V on the rank's heads,
its encoder output entering the group once; an MoE layer's experts split
over "model", its routing
ids gathered over the axes that split the rows, and in training its aux
loss summed there, as ``models/moe.apply_moe`` runs over a mesh; a
mamba layer's SSM heads over "model", its gated norm's sum of squares
and ``out_proj``'s partials summed there, each sum's backward too, as
``models/mamba2.apply_mamba`` runs): ``prefill`` and ``decode`` on the
rank's shards of params and adapters, the decode cache at its kv heads
and SSM heads over "model", rows over the ``launch/specs.
batch_axes`` prefix of ("pod", "data"), then the greedy sample every
rank agrees on (one reduce over "model", none where the vocabulary is
whole) and every row's token gathered over the rows' axes, as
``ServeConfig.mesh`` serves.  Where the vocabulary is whole no
collective touches it: the embedding's sum, the loss's three and the
sample's reduce are not issued.

Usage (on the CPU; no card needed):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama2-7b \\
        --shape train_4k --step fdlora_round
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama2-7b \\
        --shape train_4k --mesh 2,16,16
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama2-7b \\
        --shape decode_32k --mesh 2,16,16
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dbrx-132b \\
        --shape decode_32k --mesh 1,1,8

Outputs JSON to ``experiments/dryrun_torch/<arch>__<shape>__<mesh>__<step>
[__<variant>].json``, ``<mesh>`` "1xh100", or the ``--mesh`` shape (as
"2x16x16").
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis import roofline as rl
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import (ALL_ARCHS, config_for_shape,
                                          shape_supported)
from repro_torch.core.lora import adapter_specs, init_adapters, lora_scale
from repro_torch.core.partition import AXES, spec_map
from repro_torch.kernels import meta
from repro_torch.kernels.lora_matmul import lora_matmul_op
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs as sp
from repro_torch.models.api import Model
from repro_torch.models.tensor_parallel import (check_model_axis,
                                                shard_leaf,
                                                vocab_parallel_greedy,
                                                vocab_split)
from repro_torch.training.optimizers import adamw
from repro_torch.training.train_step import (make_full_train_step,
                                             make_lora_train_step)

META = torch.device("meta")
MESH = "1xh100"
CARD_BYTES = 80 * 2 ** 30            # the data sheet's 80 GB of HBM3

# ops whose bytes the tally does not count: allocations (their outputs
# are allocated, not written), and kernel launches that are operators of
# their own (their fake implementation records the launch's bytes
# through ``kernels/meta.py``)
_NO_BYTES = {torch.ops.aten.empty.memory_format,
             torch.ops.aten.empty_like.default,
             torch.ops.aten.empty_strided.default,
             lora_matmul_op._opoverload}


def iter_tensors(obj):
    """Every tensor inside nested tuples, lists and dicts."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from iter_tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from iter_tensors(o)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages of every tensor in ``tree``."""
    seen = {}
    for t in iter_tensors(tree):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _bmm_flop(a_shape, b_shape, *_, out_shape=None, **__) -> int:
    """``aten::bmm`` of either overload (``bmm.dtype`` passes its out
    dtype as a third argument, which torch's own formula mistakes)."""
    b, m, k = a_shape
    return 2 * b * m * k * b_shape[-1]


class Tally(TorchDispatchMode):
    """Storages made and freed by one step on the meta device, every op's
    operand and result bytes, and the kernels' meta launches.  Storages of
    the step's ``arguments`` are neither counted nor tracked."""

    def __init__(self, arguments):
        super().__init__()
        self.known = {t.untyped_storage()._cdata
                      for t in iter_tensors(arguments)}
        self.live: Dict[int, tuple] = {}
        self.live_bytes = 0
        self.peak_temp = 0
        self.op_bytes = 0.0
        self.kernels: Dict[str, Dict[str, float]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = list(iter_tensors(out))
        if not (func.is_view or func in _NO_BYTES):
            self.op_bytes += sum(_nbytes(t) for t in
                                 iter_tensors((args, kwargs, outs)))
        for t in outs:
            self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.known or key in self.live:
            return
        n = st.nbytes()
        self.live[key] = (weakref.ref(st, lambda _r, k=key: self._free(k)), n)
        self.live_bytes += n
        self.peak_temp = max(self.peak_temp, self.live_bytes)

    def _free(self, key: int) -> None:
        entry = self.live.pop(key, None)
        if entry is not None:
            self.live_bytes -= entry[1]

    def kernel(self, name: str, cost: meta.Cost) -> None:
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0,
                                           "bytes": 0.0, "scratch_bytes": 0.0})
        k["launches"] += 1
        k["flops"] += cost.flops
        k["bytes"] += cost.bytes_read + cost.bytes_written
        k["scratch_bytes"] = max(k["scratch_bytes"], cost.scratch_bytes)
        self.peak_temp = max(self.peak_temp,
                             self.live_bytes + cost.scratch_bytes)


def measure(fn, arguments: Dict, model_flops: float = 0.0,
            chips: int = 1) -> Dict:
    """Run ``fn()`` (a step over meta tensors) under the tally, the FLOP
    counter and the kernels' meta records; ``arguments`` names the trees
    the step takes.  Returns the ``memory``, ``roofline``, ``counts`` and
    ``kernels`` entries of a result, and ``collectives``: those the step
    logged (``launch/mesh.all_reduce`` on meta tensors), which the
    roofline's collective term reads for ``chips`` cards."""
    arg_bytes = storage_bytes(arguments)
    tally = Tally(arguments)
    counter = FlopCounterMode(display=False,
                              custom_mapping={torch.ops.aten.bmm: _bmm_flop})
    mesh_lib.reset_collectives()
    with meta.recording(tally.kernel), counter, tally:
        out = fn()
    colls = mesh_lib.collectives()
    out_bytes = sum(n for key, n in
                    {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                     for t in iter_tensors(out)}.items()
                    if key not in tally.known)
    op_flops = float(counter.get_total_flops())
    k_flops = sum(k["flops"] for k in tally.kernels.values())
    k_bytes = sum(k["bytes"] for k in tally.kernels.values())
    roof = rl.analyze(op_flops + k_flops, tally.op_bytes + k_bytes, chips,
                      model_flops, colls)
    return {"memory": {"argument_bytes": arg_bytes,
                       "argument_bytes_by": {n: storage_bytes(t) for n, t
                                             in arguments.items()},
                       "output_bytes": out_bytes,
                       "temp_bytes": tally.peak_temp,
                       "peak_bytes": arg_bytes + tally.peak_temp},
            "roofline": roof.to_dict(),
            "counts": {"op_flops": op_flops, "kernel_flops": k_flops,
                       "op_bytes": tally.op_bytes, "kernel_bytes": k_bytes,
                       "op_bytes_are": "every plain op's operands and "
                                       "result, unfused: an upper bound"},
            "kernels": tally.kernels,
            "collectives": [dataclasses.asdict(c) for c in colls]}


class RankMesh:
    """Rank 0 of a ``("pod", "data", "model")`` mesh as the round and the
    collectives read it (axis names, sizes, this rank's coordinate): on
    meta tensors ``launch/mesh.all_reduce`` logs and issues nothing."""
    mesh_dim_names = AXES

    def __init__(self, shape):
        self.shape = tuple(shape)

    def size(self, i: int) -> int:
        return self.shape[i]

    def get_coordinate(self):
        return (0,) * len(self.shape)


# ---------------------------------------------------------------------------
# the four steps, each over meta parameters, adapters, state and inputs
# ---------------------------------------------------------------------------

def _params_adapters(model, cfg, mesh=None):
    """Meta params and adapters, at one rank's shard shapes on a mesh
    (its block of the experts and its SSM heads' columns too), each
    adapter leaf cut as ``tensor_parallel.shard_leaf`` cuts it."""
    if mesh is None or mesh.shape[2] == 1:
        return model.init(), init_adapters(cfg, device=META)
    size = mesh.shape[2]
    check_model_axis(cfg, size)
    adapters = spec_map(lambda s, t: shard_leaf(t, s, size, 0),
                        adapter_specs(cfg), init_adapters(cfg, device=META))
    return model.init(shard=(size, 0)), adapters


def _rows(B: int, ranks: int) -> int:
    if B % ranks:
        raise ValueError(f"{B} rows do not split over {ranks} ranks")
    return B // ranks


def build_train(model, cfg, B: int, S: int, mesh=None):
    """The paper's train step: LoRA SFT of a frozen base, AdamW.  On a
    mesh each rank takes B / (pod · data) rows, its gradient summed over
    "data" then "pod", and its model group's shards."""
    opt = adamw(lr=2e-4)
    model_flops = rl.model_flops_train(cfg, B * S)   # over every rank
    tp = reduce_data = dp = None
    if mesh is not None:
        pod, data, _ = mesh.shape
        B = _rows(B, pod * data)
        tp = mesh_lib.model_group(mesh)
        dp = mesh_lib.data_group(mesh, ("pod", "data"))
        axes = [a for a, n in (("data", data), ("pod", pod)) if n > 1]
        if axes:
            def reduce_data(t):
                for a in axes:
                    mesh_lib.all_reduce(t, mesh, a)
                return t
    step = make_lora_train_step(model, cfg, opt, paged_backend="cuda",
                                tp=tp, reduce_data=reduce_data, dp=dp)
    params, adapters = _params_adapters(model, cfg, mesh)
    opt_state = opt.init(adapters)
    batch = sp.batch_inputs(cfg, B, S)
    return ((lambda: step(params, adapters, opt_state, batch)),
            {"params": params, "adapters": adapters, "opt_state": opt_state,
             "inputs": batch}, model_flops)


def build_full_train(model, cfg, B: int, S: int):
    """Full fine-tuning (``make_full_train_step``): every weight trains
    under AdamW, no adapter.  Not one of the CLI's steps (the reference's
    dry run has none); ``chip_smoke.py`` walks it to choose the depth of
    its ``full_train`` phase."""
    opt = adamw(lr=2e-4)
    step = make_full_train_step(model, cfg, opt, paged_backend="cuda")
    params = model.init()
    opt_state = opt.init(params)
    batch = sp.batch_inputs(cfg, B, S)
    return ((lambda: step(params, opt_state, batch)),
            {"params": params, "opt_state": opt_state, "inputs": batch},
            rl.model_flops_train(cfg, B * S))


def _serve_rank(B: int, mesh):
    """A serving step's rows on one rank of ``mesh`` (B / the product of
    the ``batch_axes`` prefix of ("pod", "data")), its model group, the
    axes of size > 1 its rows are split over (the minor first) and their
    data group."""
    if mesh is None:
        return B, None, (), None
    sizes = dict(zip(AXES, mesh.shape))
    axes = sp.batch_axes(mesh, B) or ()
    for a in axes:
        B = _rows(B, sizes[a])
    split = tuple(a for a in ("data", "pod") if a in axes and sizes[a] > 1)
    return (B, mesh_lib.model_group(mesh), split,
            mesh_lib.data_group(mesh, split[::-1]))


def greedy_tokens(cfg, logits, mesh, tp, split):
    """The step's greedy sample as every rank takes it (``ServeConfig.
    mesh``): the vocabulary-parallel argmax of the last position (one
    reduce over "model"; the plain argmax where the vocabulary is whole),
    then every row's token gathered over the axes the rows are split
    over."""
    last = logits[:, -1]
    tok = (vocab_parallel_greedy(last, tp)
           if tp is not None and vocab_split(cfg, tp.size)
           else torch.argmax(last, -1)).to(torch.int32)
    for a in split:
        tok = mesh_lib.all_gather(tok, mesh, a).reshape(-1)
    return tok


def _scratch_syncs(cfg, tp, dp, block_size: int, kv_dtype: str):
    """The serving step's scratch-block syncs (``layers.sync_scratch``:
    one gather per attention layer, of a model with MoE layers whose rows
    a data group splits), logged on the meta device: the walks run the
    unpaged forward, which has no pool."""
    if dp is None or not cfg.has_moe():
        return
    from repro_torch.models import layers as L
    pool = L.init_paged_kv_cache(cfg, 1, block_size, torch.bfloat16, META,
                                 kv_dtype, tp)
    for i in range(cfg.n_layers):
        if cfg.layer_entry(i).startswith("attn"):
            L.sync_scratch(pool, None, None, None, 0, dp)


def build_prefill(model, cfg, B: int, S: int, mesh=None,
                  block_size: int = 16, kv_dtype: str = "f32"):
    """Inference prefill: a whole forward, the last position unembedded
    (every position for the encoder-decoder, as the reference).  On a
    mesh the rank's rows and shards, then the sample every rank takes
    (and the scratch-block syncs of a paged pool of ``block_size`` and
    ``kv_dtype``, :func:`_scratch_syncs`)."""
    scale = lora_scale(cfg)
    B, tp, split, dp = _serve_rank(B, mesh)
    params, adapters = _params_adapters(model, cfg, mesh)
    batch = sp.batch_inputs(cfg, B, S)
    batch.pop("loss_mask")

    def fn():
        with torch.no_grad():
            logits = model.forward(params, batch, adapters=adapters,
                                   lora_scale=scale,
                                   last_only=not cfg.is_encdec,
                                   paged_backend="cuda", tp=tp, dp=dp,
                                   need_aux=False)[0]
            if mesh is None:
                return logits
            _scratch_syncs(cfg, tp, dp, block_size, kv_dtype)
            return logits, greedy_tokens(cfg, logits, mesh, tp, split)
    return (fn, {"params": params, "adapters": adapters, "inputs": batch},
            rl.model_flops_decode(cfg, B * S))


def build_decode(model, cfg, B: int, S: int, mesh=None,
                 block_size: int = 16, kv_dtype: str = "f32"):
    """One decode step against a cache holding S positions (a ring of the
    window's length for windowed archs), token S - 1 written last.  On a
    mesh the rank's rows, shards and kv heads, then the sample every rank
    takes (and the scratch-block syncs, as :func:`build_prefill`)."""
    scale = lora_scale(cfg)
    B, tp, split, dp = _serve_rank(B, mesh)
    params, adapters = _params_adapters(model, cfg, mesh)
    cache = model.init_decode_cache(B, S, tp=tp)
    for lc in ([cache["self"]] if cfg.is_encdec else cache["layers"]):
        if "pos" in lc:
            lc["pos"] = S - 1
    dec = sp.step_inputs(B)

    def fn():
        with torch.no_grad():
            out = model.decode_step(params, cache, dec["tokens"], S - 1,
                                    adapters=adapters, lora_scale=scale,
                                    paged_backend="cuda", tp=tp, dp=dp)
            if mesh is None:
                return out
            _scratch_syncs(cfg, tp, dp, block_size, kv_dtype)
            return out, greedy_tokens(cfg, out[0], mesh, tp, split)
    return (fn, {"params": params, "adapters": adapters, "cache": cache,
                 "inputs": dec}, rl.model_flops_decode(cfg, B))


def build_fdlora_round(model, cfg, B: int, S: int, mesh=None,
                       n_clients: int = 2, K: int = 3):
    """One FDLoRA round: K inner AdamW steps for each of ``n_clients``
    clients on B / n_clients rows, then the outer Nesterov step.  Each
    client's batches carry the VLM's patch or the encoder-decoder's frame
    embeddings too (the reference's round batches hold tokens and masks
    only, which those families' forwards cannot run on).  On a mesh the
    rank takes the clients of its pod coordinate, its 1 / data of each
    client's rows, and its model group's shards."""
    from repro_torch.core.outer_opt import make_outer_optimizer
    from repro_torch.federated.distributed import (make_fdlora_round_step,
                                                   stack_clients)
    inner = adamw(lr=2e-4)
    outer = make_outer_optimizer("nesterov", 1e-3, 0.5)
    round_step = make_fdlora_round_step(
        model, cfg.with_overrides(paged_backend="cuda"), inner, outer, K,
        mesh=mesh)
    params, theta = _params_adapters(model, cfg, mesh)
    pod, data = (1, 1) if mesh is None else mesh.shape[:2]
    n_local = _rows(n_clients, pod)
    state = {"inner_opt": stack_clients([inner.init(theta)] * n_local),
             "outer_opt": outer.init(theta)}
    B_local = _rows(_rows(B, n_clients), data)
    batches = {n: torch.empty((n_local, K, *t.shape), dtype=t.dtype,
                              device=META)
               for n, t in sp.batch_inputs(cfg, B_local, S).items()}
    return ((lambda: round_step(params, theta, state, batches)),
            {"params": params, "adapters": theta, "opt_state": state,
             "inputs": batches},
            rl.model_flops_train(cfg, K * _rows(B, n_clients) * n_clients
                                 * S))


BUILDERS = {"train": build_train, "prefill": build_prefill,
            "decode": build_decode, "fdlora_round": build_fdlora_round}

# the reference's variants: those that change a field the port reads
VARIANTS = {"baseline": {},
            "no_remat": {"remat": False},
            "remat_dots": {"remat_policy": "dots"},
            "moe_cap1": {"moe_capacity_factor": 1.0},
            "opt_moe": {"moe_capacity_factor": 1.0, "remat_policy": "dots"}}
# those that only steer the reference's XLA lowering
XLA_ONLY_VARIANTS = ("gqa_grouped", "sm_bf16", "opt_attn", "serve2d",
                     "bf16_outer")


def device_entry() -> Dict:
    """The card's name and memory: the card's own when one is present,
    else the data sheet's."""
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        return {"name": props.name, "memory_bytes": props.total_memory,
                "source": "torch.cuda.get_device_properties(0)"}
    return {"name": rl.CARD, "memory_bytes": CARD_BYTES,
            "source": "data sheet"}


def dry_run(cfg, step: str, B: int, S: int, mesh=None, **opts) -> Dict:
    """One step of ``cfg`` at B rows of S tokens on the meta device; the
    result's ``params``, ``memory``, ``roofline``, ``counts``,
    ``kernels`` and ``collectives`` entries.  ``mesh`` (pod, data,
    model): one rank's step there (the model axis for every family
    whose split counts divide, refused otherwise naming the count).
    ``opts`` go to the step's ``build_*`` (``n_clients``, ``K`` of the
    round)."""
    model = Model(cfg, META)
    chips = 1
    if mesh is not None:
        check_model_axis(cfg, mesh[2])
        chips = mesh[0] * mesh[1] * mesh[2]
        opts["mesh"] = RankMesh(mesh)
    fn, args, model_flops = BUILDERS[step](model, cfg, B, S, **opts)
    res = measure(fn, args, model_flops, chips)
    return {"params": cfg.count_params(),
            "active_params": cfg.count_active_params(),
            "lora_params": cfg.count_lora_params(), "remat": cfg.remat,
            "remat_policy": cfg.remat_policy, **res}


def check_variant(variant: str) -> None:
    if variant in XLA_ONLY_VARIANTS:
        raise ValueError(f"variant {variant!r} only steers the reference's "
                         "XLA lowering; the port has nothing it changes")
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")


def mesh_tag(mesh=None) -> str:
    return "x".join(map(str, mesh)) if mesh else MESH


def run_one(arch: str, shape_name: str, step: str = "auto",
            variant: str = "baseline",
            out_dir: str = "experiments/dryrun_torch",
            smoke: bool = False, mesh=None) -> Dict:
    """One arch x shape x step; ``mesh`` (pod, data, model; the
    reference's multi-pod mesh is (2, 16, 16)): one rank of that mesh,
    per-rank memory and the collective log (a config whose split counts
    do not divide is skipped, naming the count)."""
    if not shape_supported(arch, shape_name):
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": "whisper-small's decoder context is bounded by "
                          "its design"}
    check_variant(variant)
    cfg = config_for_shape(arch, shape_name, smoke=smoke)
    cfg = cfg.with_overrides(paged_backend="cuda", **VARIANTS[variant])
    if step == "auto":
        step = INPUT_SHAPES[shape_name].kind
    if mesh is not None:
        try:
            check_model_axis(cfg, mesh[2])
        except ValueError as e:
            return {"arch": arch, "shape": shape_name, "skipped": True,
                    "reason": str(e)}
    sh = INPUT_SHAPES[shape_name]
    t0 = time.time()
    res = dry_run(cfg, step, sh.global_batch, sh.seq_len, mesh=mesh)
    dev = device_entry()
    tag_mesh = mesh_tag(mesh)
    result = {"arch": arch, "shape": shape_name, "mesh": tag_mesh,
              "step": step, "variant": variant,
              "chips": res["roofline"]["chips"],
              "walk_s": round(time.time() - t0, 2), **res, "device": dev,
              "fits": res["memory"]["peak_bytes"] <= dev["memory_bytes"]}
    if mesh is not None:
        result["mesh_shape"] = dict(zip(AXES, mesh))
        result["per_rank"] = True
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{arch}__{shape_name}__{tag_mesh}__{step}"
    if variant != "baseline":
        tag += f"__{variant}"
    if smoke:
        tag += "__smoke"
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=ALL_ARCHS + ["all"])
    ap.add_argument("--shape", required=True,
                    choices=list(INPUT_SHAPES) + ["all"])
    ap.add_argument("--step", default="auto",
                    choices=["auto", "train", "prefill", "decode",
                             "fdlora_round"])
    ap.add_argument("--variant", default="baseline",
                    help=f"one of {sorted(VARIANTS)}; "
                         f"{', '.join(XLA_ONLY_VARIANTS)} are refused")
    ap.add_argument("--mesh", type=lambda v: tuple(map(int, v.split(","))),
                    help="POD,DATA,MODEL: one rank of that (pod, data, "
                         "model) mesh, 2,16,16 the reference's multi-pod "
                         "one; every step, every arch whose head, ff, "
                         "expert and SSM-head counts divide"),
    ap.add_argument("--out-dir", default="experiments/dryrun_torch")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--skip-existing", action="store_true",
                    help="skip combos whose JSON artifact already exists")
    args = ap.parse_args(argv)
    try:
        check_variant(args.variant)
    except ValueError as e:
        ap.error(str(e))

    archs = ALL_ARCHS if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    failures = []
    tag_mesh = mesh_tag(args.mesh)
    for arch in archs:
        for shape in shapes:
            kind = INPUT_SHAPES[shape].kind
            if args.step != "auto":
                steps = [args.step]
            elif args.mesh and kind == "train":
                steps = ["train", "fdlora_round"]
            else:
                steps = [kind]
            for step in steps:
                tag = f"{arch}__{shape}__{tag_mesh}__{step}"
                if args.variant != "baseline":
                    tag += f"__{args.variant}"
                if args.smoke:
                    tag += "__smoke"
                if args.skip_existing and os.path.exists(
                        os.path.join(args.out_dir, tag + ".json")):
                    print(f"SKIP-EXISTING {arch} {shape} {step}")
                    continue
                try:
                    r = run_one(arch, shape, step, args.variant,
                                args.out_dir, args.smoke, args.mesh)
                except Exception as e:  # keep sweeping; report at the end
                    failures.append((arch, shape, repr(e)[:300]))
                    print(f"FAIL {arch} {shape}: {repr(e)[:300]}")
                    sys.stdout.flush()
                    continue
                if r.get("skipped"):
                    print(f"SKIP {arch} {shape}: {r['reason']}")
                    break
                roof, mem = r["roofline"], r["memory"]
                print(f"OK {arch} {shape} {r['mesh']} {r['step']} "
                      f"walk={r['walk_s']}s "
                      f"args={mem['argument_bytes'] / 1e9:.2f}GB "
                      f"peak={mem['peak_bytes'] / 1e9:.2f}GB "
                      f"fits={r['fits']} compute={roof['compute_s']:.4f}s "
                      f"memory={roof['memory_s']:.4f}s "
                      f"collective={roof['collective_s']:.4f}s "
                      f"dom={roof['dominant']} "
                      f"useful={roof['useful_ratio']:.2f}")
                sys.stdout.flush()
    if failures:
        print(f"{len(failures)} FAILURES:")
        for a, s, e in failures:
            print(" ", a, s, e)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
