"""Checkpointing: the port's trees <-> flat ``.npz`` archives.

Port of ``repro/training/checkpoint.py`` with the same archive layout, so
either package reads what the other wrote: keys are ``/``-joined tree
paths (``\\x1f`` inside the npz), bf16 is stored as its uint16 bits, and a
sidecar ``<path>.meta.json`` holds the dtypes and free-form metadata.

The reference stacks layers on a period axis (``blocks/b<j>/...`` with
leaves ``(n_periods, ...)``); the port keeps ``layers`` as a list.  Saving
writes the port's layers as one block ``b0`` stacked over every layer (the
dense family's layout); loading unstacks ``blocks`` of any period back
into ``layers`` (``bridge.py``).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import bridge, resolve_device

Params = Any


def _flatten(tree, prefix="") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif tree is not None:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any]) -> Params:
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _stack_layers(layers):
    """[layer tree, ...] -> one tree whose leaves stack the layers."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack_layers([l[k] for l in layers]) for k in first}
    return torch.stack([l.detach() for l in layers])


def _to_numpy(t: torch.Tensor):
    """(array to store, dtype name); bf16 goes as its uint16 bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def save_checkpoint(path: str, tree: Params,
                    metadata: Optional[Dict] = None) -> None:
    """Write ``tree`` (the port's layout: a ``layers`` list plus any other
    leaves) as ``path`` (npz) and ``path.meta.json``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tree = dict(tree)
    if "layers" in tree:
        tree["blocks"] = {"b0": _stack_layers(tree.pop("layers"))}
    arrays, dtypes = {}, {}
    for k, v in _flatten(tree).items():
        arrays[k.replace("/", "\x1f")], dtypes[k] = _to_numpy(v)
    np.savez(path, **arrays)
    with open(path + ".meta.json", "w") as f:
        json.dump({"dtypes": dtypes, "metadata": metadata or {}}, f)


def load_checkpoint(path: str, device="cuda") -> Params:
    """Read an archive written by either package into the port's layout,
    on ``device`` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    flat = {}
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        for key in data.files:
            k = key.replace("\x1f", "/")
            v = data[key]
            if meta["dtypes"][k] == "bfloat16":
                flat[k] = torch.from_numpy(v.view(np.int16)).view(
                    torch.bfloat16).to(dev)
            else:
                flat[k] = torch.from_numpy(v).to(dev)
    tree = _unflatten(flat)
    if "blocks" in tree:
        tree["layers"] = bridge.unstack_blocks(tree.pop("blocks"), dev)
    return tree
