"""Nested-dict parameter trees: flatten, rebuild and map in the JAX
package's leaf order.

``jax.tree_util`` walks a dict in **sorted key order**, whatever order its
keys were inserted in; every flattening here does the same, so leaf
indices, packed ring rows and checkpoint leaf ids agree with the JAX
package's.  A path is the tuple of dict keys from the root to a leaf.
"""
from __future__ import annotations

import functools
from typing import Any, Callable

import torch

Path = tuple[str, ...]


def leaves_with_path(tree: Any, prefix: Path = ()) -> list[tuple[Path, Any]]:
    """``[(path, leaf), ...]`` in sorted key order; a non-dict is a leaf."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out: list[tuple[Path, Any]] = []
    for k in sorted(tree):
        out.extend(leaves_with_path(tree[k], prefix + (k,)))
    return out


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def unflatten(paths: list[Path], values: list) -> Any:
    """The nested dict holding ``values`` at ``paths`` (an empty path is
    the root itself)."""
    if len(paths) == 1 and paths[0] == ():
        return values[0]
    out: dict = {}
    for path, v in zip(paths, values):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = v
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over matching leaves of trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def ravel(tree: Any) -> tuple[torch.Tensor, Callable[[torch.Tensor], Any]]:
    """The counterpart of ``jax.flatten_util.ravel_pytree``: the leaves in
    JAX's order, each flattened C-order, concatenated into one vector of
    their common dtype; and ``unravel(vec)``, the tree of ``vec``'s pieces
    in the leaves' shapes and dtypes (views of ``vec`` where the dtype is
    the vector's)."""
    lv = leaves_with_path(tree)
    paths = [p for p, _ in lv]
    metas = [(t.shape, t.dtype, t.numel()) for _, t in lv]
    dtype = functools.reduce(torch.promote_types, [d for _, d, _ in metas])
    flat = torch.cat([t.reshape(-1).to(dtype) for _, t in lv])

    def unravel(vec: torch.Tensor) -> Any:
        out, off = [], 0
        for shape, dt, n in metas:
            out.append(vec[off:off + n].view(shape).to(dt))
            off += n
        return unflatten(paths, out)
    return flat, unravel
