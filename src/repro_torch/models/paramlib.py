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
from typing import Any

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


def init_tree(specs, generator: torch.Generator, dtype=torch.float32):
    """Materialize parameters on the generator's device, leaf by leaf in
    path order (one draw per normal leaf from ``generator``)."""
    dev = generator.device

    def make(spec: P) -> torch.Tensor:
        dt = spec.dtype or dtype
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=dev)
        x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return (x * _std(spec)).to(dt)

    def walk(node):
        return {k: make(node[k]) if isinstance(node[k], P) else walk(node[k])
                for k in sorted(node)}

    return walk(specs)


def param_count(specs) -> int:
    return sum(math.prod(s.shape) for _, s in leaves(specs))
