"""Parameter specification trees (own copy of ``repro.models.paramlib``).

A model describes its parameters once, as a nested dict of :class:`P`
specs (shape + logical axes + initializer).  ``init_tree`` materializes
them with an explicit ``torch.Generator``: a normal draw times ``_std``,
as the JAX package does.  The bits differ from ``jax.random``; parity
tests hand both packages the same numpy tree instead
(``repro_torch.checkpoint.params_from_numpy``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class P:
    """Spec for one parameter tensor."""
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]            # logical axis name per dim
    init: str = "normal"                    # normal | zeros | ones
    scale: float | None = None              # stddev; default 1/sqrt(fan_in)
    fan_in_dim: int = -2                    # which dim is fan-in for scaling
    dtype: Any = None                       # override model dtype
    keep_f32: bool = False                  # read in f32: serving keeps f32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} / axes {self.axes} mismatch")


def _std(spec: P) -> float:
    if spec.scale is not None:
        return spec.scale
    fan_in = spec.shape[spec.fan_in_dim] if spec.shape else 1
    return 1.0 / math.sqrt(max(fan_in, 1))


def leaves(specs, prefix: str = ""):
    """Yield ``(path, spec)`` in key order, paths joined by ``/``."""
    for k in sorted(specs):
        v = specs[k]
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, P):
            yield path, v
        else:
            yield from leaves(v, path)


def init_tree(specs, generator: torch.Generator, dtype=torch.float32,
              leaf_fn: Callable[[str, torch.Tensor, P], torch.Tensor] | None
              = None):
    """Materialize parameters on the generator's device, leaf by leaf in
    path order (one draw per normal leaf from ``generator``).  ``leaf_fn
    (name, leaf, spec)``, when given, maps each leaf as soon as it is made
    (a serving cast, say), so only one leaf of the master tree is alive at
    a time; the draws are the same with or without it."""
    dev = generator.device

    def make(spec: P) -> torch.Tensor:
        dt = spec.dtype or dtype
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=dev)
        x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return x.mul_(_std(spec)).to(dt)

    def leaf(k: str, spec: P) -> torch.Tensor:
        return make(spec) if leaf_fn is None else leaf_fn(k, make(spec),
                                                          spec)

    def walk(node):
        return {k: leaf(k, node[k]) if isinstance(node[k], P)
                else walk(node[k]) for k in sorted(node)}

    return walk(specs)


def abstract_tree(specs, dtype=torch.float32):
    """The parameters as ``meta`` tensors: shapes and dtypes, no storage
    (the dry run's stand-ins)."""
    return {k: (torch.empty(v.shape, dtype=v.dtype or dtype, device="meta")
                if isinstance(v, P) else abstract_tree(v, dtype))
            for k, v in sorted(specs.items())}


def axes_tree(specs):
    """The logical-axes tree with the parameters' structure."""
    return {k: v.axes if isinstance(v, P) else axes_tree(v)
            for k, v in sorted(specs.items())}


def param_count(specs) -> int:
    return sum(math.prod(s.shape) for _, s in leaves(specs))
