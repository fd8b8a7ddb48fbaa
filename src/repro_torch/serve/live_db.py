"""Parameter reads for serving (port of ``repro.serve.live_db``).

The serving engine never owns its weights: it holds a handle whose
``get()`` returns the current parameter tree.  This slice ports
:class:`StaticParams` (frozen weights, plain serving); the serve-while-train
``LiveParamDB`` comes with the training slice of the port.
"""
from __future__ import annotations

from typing import Any

from ..models.config import ModelConfig
from ..models.paramlib import P
from ..models.transformer import model_specs

# leaves the JAX package always casts to cfg.dtype before use
_CAST_PREFIX = "w"
_CAST_NAMES = ("embedding", "lm_head")


def serving_leaf(name: str, leaf: Any, cfg: ModelConfig, spec: P) -> Any:
    """The serving copy of one master leaf called ``name`` with the spec
    ``spec``: the weight matrices (``w*``), ``embedding`` and ``lm_head``
    cast to ``cfg.dtype`` — bit-identical to the per-use cast, which then
    costs nothing — unless the spec keeps the leaf f32 (the model reads it
    in f32: the RG-LRU's gate matrices), and every other leaf (norm scales
    and the MoE router, read as f32) as it is."""
    if spec.keep_f32:
        return leaf
    if name.startswith(_CAST_PREFIX) or name in _CAST_NAMES:
        return leaf.to(cfg.dtype)
    return leaf


def serving_params(params: dict, cfg: ModelConfig) -> dict:
    """A serving copy of an f32 master tree of ``model_specs(cfg)``, leaf
    by leaf (``serving_leaf``)."""

    def walk(node, specs):
        return {k: walk(v, specs[k]) if isinstance(v, dict)
                else serving_leaf(k, v, cfg, specs[k])
                for k, v in node.items()}

    return walk(params, model_specs(cfg))


class StaticParams:
    """Frozen-weight handle: ``get()`` always returns the same tree."""

    def __init__(self, params: Any):
        self._params = params

    def get(self) -> Any:
        return self._params
