"""Partition specs: which mesh axes split each dim of a tensor.

The port's counterpart of jax's ``PartitionSpec``, and the helpers that
read a mesh's axis names and sizes.  Plain data: the ``*_specs``
functions of ``models/``, ``core/lora.py``, ``launch/specs.py`` and
``federated/distributed.py`` build trees of :class:`P`, and read a mesh
only through :func:`mesh_shape`, so the production shapes are tested
with a plain dict standing in for a mesh.  Process groups and
collectives live in ``launch/mesh.py``.
"""
from __future__ import annotations

from typing import Callable, Dict

AXES = ("pod", "data", "model")


class P:
    """A partition spec: one entry per tensor dim, the mesh axis name it
    is split over, a tuple of names (split over their product, the first
    major), or ``None`` (replicated).  The counterpart of jax's
    ``PartitionSpec``, canonicalised as it is (a one-name tuple is the
    name).  Not a tuple, so the port's tree walkers
    (``core/lora.tree_map``) take it as a leaf."""
    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(e[0] if isinstance(e, tuple) and len(e) == 1
                             else e for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self.entries == other.entries

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"P{self.entries!r}"


def entry_axes(entry) -> tuple:
    """The axis names of one spec entry: () for None."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` in the mesh's axis order, of a ``DeviceMesh``
    or of a dict standing in for one."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}


def mesh_coordinate(mesh) -> Dict[str, int]:
    """This rank's ``{axis name: index}`` on a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def spec_map(fn: Callable, spec_tree, *trees):
    """``fn(spec, *leaves)`` over a tree of :class:`P` (dicts and lists),
    with the other trees walked alongside."""
    if isinstance(spec_tree, dict):
        return {k: spec_map(fn, v, *(t[k] for t in trees))
                for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [spec_map(fn, v, *(t[i] for t in trees))
                for i, v in enumerate(spec_tree)]
    return fn(spec_tree, *trees)


def add_leading(spec_tree, entry=None):
    """Prepend ``entry`` (replicated: None) to every spec of a tree."""
    return spec_map(lambda s: P(entry, *s), spec_tree)
