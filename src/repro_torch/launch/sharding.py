"""Logical-axis -> mesh-axis sharding resolution, and DTensor placements
(port of ``repro.launch.sharding``).

A tensor's dims carry logical names (``core/sync.py``); rules map each name
to an ordered list of candidates (a mesh axis or a tuple of axes).  The
first candidate whose total size divides the dim and whose mesh axes are
not already used by another dim of the same tensor wins; otherwise the dim
is replicated.  :func:`resolve_spec` returns the per-dim spec as a tuple
(None, an axis name, or a tuple of axis names: JAX's ``PartitionSpec``
entries); :func:`placements` turns it into DTensor ``Shard``/``Replicate``
per mesh dim.  A mesh here is a ``DeviceMesh`` with named dims, or, for
resolution alone, any mapping {axis name: size}.
"""
from __future__ import annotations

import math
import os
from typing import Any, Mapping, Sequence

from torch.distributed.tensor import (DeviceMesh, DTensor, Placement,
                                      Replicate, Shard, distribute_tensor)

from ..core.sync import ACTIVATION_RULES
from ..tree import tree_map

Rules = Mapping[str, Sequence[Any]]
Spec = tuple  # per tensor dim: None | axis name | tuple of axis names
Placements = tuple  # per mesh dim: Shard(d) | Replicate()


def activation_rules() -> Rules:
    """Activation rules, honoring ``REPRO_DP_OVER_MODEL=1``: the ``model``
    axis as additional data parallelism (small dense archs whose TP
    all-reduces dominate).  The parameter database stays sharded over
    ``data``."""
    if os.environ.get("REPRO_DP_OVER_MODEL") == "1":
        return {**ACTIVATION_RULES,
                "batch": (("pod", "data", "model"), ("data", "model"),
                          ("data",))}
    return ACTIVATION_RULES


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def resolve_spec(logical_axes: Sequence[str | None], shape: Sequence[int],
                 mesh, rules: Rules) -> Spec:
    sizes = axis_sizes(mesh)
    spec: list[Any] = []
    used: set[str] = set()
    for dim, name in zip(shape, logical_axes):
        choice = None
        if name is not None:
            for cand in rules.get(name, ()):
                axes = (cand,) if isinstance(cand, str) else tuple(cand)
                if not all(a in sizes for a in axes):
                    continue
                if set(axes) & used:
                    continue
                if dim % math.prod(sizes[a] for a in axes) != 0:
                    continue
                choice = axes[0] if len(axes) == 1 else axes
                used.update(axes)
                break
        spec.append(choice)
    return tuple(spec)


def _spec_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Spec, mesh: DeviceMesh) -> Placements:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every
    mesh dim that tensor dim d is split over, ``Replicate()`` elsewhere.
    A dim on several axes (("pod", "data")) is split over them major to
    minor, which must be the mesh's order, as DTensor splits in mesh-dim
    order."""
    names = list(mesh.mesh_dim_names)
    out: list[Placement] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        idx = [names.index(a) for a in _spec_axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes of dim {d} are not in the "
                             f"mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> tuple[int, ...]:
    """One rank's shard shape of a tensor of ``shape`` laid out by
    ``spec`` (resolved specs always divide)."""
    sizes = axis_sizes(mesh)
    return tuple(n // math.prod(sizes[a] for a in _spec_axes(e))
                 for n, e in zip(shape, spec))


def tree_specs(axes_tree, like_tree, mesh, rules: Rules):
    """The resolved spec of every leaf: ``axes_tree`` holds each leaf's
    logical axes, ``like_tree`` tensors (``meta`` ones will do) of the
    same structure."""
    return tree_map(lambda ax, t: resolve_spec(ax, t.shape, mesh, rules),
                    axes_tree, like_tree)


def tree_shardings(axes_tree, like_tree, mesh: DeviceMesh, rules: Rules):
    """The placements of every leaf (JAX's ``NamedSharding`` tree)."""
    return tree_map(lambda s: placements(s, mesh),
                    tree_specs(axes_tree, like_tree, mesh, rules))


def batch_shardings(batch_axes: dict, batch_like: dict, mesh: DeviceMesh,
                    rules: Rules | None = None) -> dict:
    rules = rules or activation_rules()
    return {k: placements(resolve_spec(batch_axes[k], batch_like[k].shape,
                                       mesh, rules), mesh)
            for k in batch_like}


def replicated(mesh: DeviceMesh) -> Placements:
    return tuple(Replicate() for _ in mesh.shape)


def opt_state_shardings(param_shardings, opt_state_like, mesh: DeviceMesh):
    """The moments (``m``, ``v``, ``mom``) and the compression residual
    mirror the parameters' placements; scalars (``step``) replicate."""
    return {k: (param_shardings if k in ("m", "v", "mom", "residual")
                else tree_map(lambda _: replicated(mesh), v))
            for k, v in opt_state_like.items()}


def distribute_tree(tree, shardings, mesh: DeviceMesh):
    """DTensors of a tree of full tensors (the same on every rank), each
    laid out by its placements in ``shardings``."""
    return tree_map(lambda t, pl: distribute_tensor(t, mesh, list(pl)),
                    tree, shardings)


def full_tree(tree):
    """Plain full tensors of a tree of DTensors (an all-gather each)."""
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)
