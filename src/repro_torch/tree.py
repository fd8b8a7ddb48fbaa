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


def unflatten(like: Any, values: list) -> Any:
    """The tree of ``like``'s structure holding ``values`` in leaf order,
    the counterpart of ``jax.tree_util.tree_unflatten`` with ``like``'s
    treedef: an empty subtree of ``like`` (olmo's ``layernorm_np`` norms
    have no parameters) stays an empty dict.  ``like``'s leaves are not
    read; ``structure`` gives a ``like`` that holds no tensor."""
    n = len(leaves(like))
    if n != len(values):
        raise ValueError(f"unflatten: {len(values)} values for {n} leaves")
    return _build(like, iter(values))


def _build(node: Any, it) -> Any:
    # a module-level function: a nested recursive one would sit in a
    # reference cycle with the iterator, keeping every value alive until
    # the cycle collector runs (a step's gradients, gigabytes on a card)
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    return next(it)


def structure(tree: Any) -> Any:
    """``tree`` with every leaf replaced by None: its structure, empty
    subtrees included, for ``unflatten``."""
    return tree_map(lambda _: None, tree)


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
    like = structure(tree)
    metas = [(t.shape, t.dtype, t.numel()) for _, t in lv]
    dtype = functools.reduce(torch.promote_types, [d for _, d, _ in metas])
    flat = torch.cat([t.reshape(-1).to(dtype) for _, t in lv])

    def unravel(vec: torch.Tensor) -> Any:
        out, off = [], 0
        for shape, dt, n in metas:
            out.append(vec[off:off + n].view(shape).to(dt))
            off += n
        return unflatten(like, out)
    return flat, unravel
