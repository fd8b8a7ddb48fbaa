"""Parameter reads for serving (port of ``repro.serve.live_db``).

The serving engine never owns its weights: it holds a handle whose
``get()`` returns the current parameter tree.  This slice ports
:class:`StaticParams` (frozen weights, plain serving); the serve-while-train
``LiveParamDB`` comes with the training slice of the port.
"""
from __future__ import annotations

from typing import Any

from ..models.config import ModelConfig

# leaves the JAX package always casts to cfg.dtype before use
_CAST_PREFIX = "w"
_CAST_NAMES = ("embedding", "lm_head")


def serving_leaf(name: str, leaf: Any, cfg: ModelConfig) -> Any:
    """The serving copy of one master leaf called ``name``: the weight
    matrices (``w*``), ``embedding`` and ``lm_head`` cast to ``cfg.dtype``
    — bit-identical to the per-use cast, which then costs nothing — and
    every other leaf (norm scales and the MoE router, read as f32) as it
    is."""
    if name.startswith(_CAST_PREFIX) or name in _CAST_NAMES:
        return leaf.to(cfg.dtype)
    return leaf


def serving_params(params: dict, cfg: ModelConfig) -> dict:
    """A serving copy of an f32 master tree, leaf by leaf
    (``serving_leaf``)."""

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else serving_leaf(k, v, cfg)
                for k, v in node.items()}

    return walk(params)


class StaticParams:
    """Frozen-weight handle: ``get()`` always returns the same tree."""

    def __init__(self, params: Any):
        self._params = params

    def get(self) -> Any:
        return self._params
