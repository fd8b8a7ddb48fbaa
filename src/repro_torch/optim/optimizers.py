"""Optimizers over nested dicts of tensors (port of
``repro.optim.optimizers``).

AdamW with f32 moments over an f32 master copy (new parameters are cast
back to each leaf's dtype), SGD / momentum, global-norm clipping, and the
int8 gradient compression with error feedback.  These are plain tensor
operations, as in the JAX package, where no Pallas kernel stands either,
but for AdamW's update of each leaf: on the card one pass of a CUDA kernel
(``kernels/adamw.py``), elsewhere its plain version, the same arithmetic.

The update is functional, like JAX's: it returns new parameters and a new
state and leaves its inputs as they were, so a driver that rejects a step
(a non-finite loss) still holds the prior state.  Scalars that depend on
the data (the clip scale, the bias corrections) stay on the device: an
update never synchronises with the host.  The clip scale is applied to
each gradient leaf inside the update rather than as a separate clipped
tree, which gives the same bits without a second copy of the gradients.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from ..device import on_mesh_of
from ..kernels.adamw import adamw
from ..trace import span
from ..tree import leaves, tree_map, unflatten

PyTree = Any


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"            # adamw | sgd | momentum
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    momentum: float = 0.9
    grad_clip: float = 1.0         # global-norm clip; 0 disables
    compression: str = "none"      # none | int8


class Optimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree], tuple[PyTree, PyTree]]
    # update(grads, opt_state, params) -> (new_params, new_opt_state)


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, summed leaf by
    leaf in the JAX package's leaf order; a 0-d device tensor."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def _clip_scale(grads: PyTree, max_norm: float) -> torch.Tensor:
    norm = global_norm(grads)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: PyTree, max_norm: float) -> PyTree:
    scale = _clip_scale(grads, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), grads)


# ---------------------------------------------------------------------------
# int8 gradient compression with error feedback
# ---------------------------------------------------------------------------

def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization."""
    xf = x.float()
    scale = torch.max(torch.abs(xf)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_grads(grads: PyTree, residual: PyTree
                   ) -> tuple[PyTree, PyTree]:
    """Error-feedback int8 compression: quantize (grad + residual); the
    quantization error is carried to the next step so the *accumulated*
    gradient signal is unbiased (1-bit-Adam-style memory compensation)."""
    pairs = tree_map(lambda g, r: _compress_one(g, r), grads, residual)
    deq = tree_map(lambda p: p[0], pairs)
    new_res = tree_map(lambda p: p[1], pairs)
    return deq, new_res


def _compress_one(g: torch.Tensor, r: torch.Tensor):
    target = g.float() + r
    q, scale = quantize_int8(target)
    deq = dequantize_int8(q, scale)
    return (deq.to(g.dtype), target - deq)


def init_residual(params: PyTree) -> PyTree:
    return tree_map(lambda p: torch.zeros_like(
        p, dtype=torch.float32, memory_format=torch.contiguous_format),
        params)


def _zeros_f32(params: PyTree) -> PyTree:
    return init_residual(params)


def _step0(params: PyTree) -> torch.Tensor:
    first = leaves(params)[0]
    return on_mesh_of(torch.zeros((), dtype=torch.int32, device=first.device),
                      first)


def _prepare(cfg: OptConfig, grads: PyTree, state: dict, new_state: dict
             ) -> tuple[PyTree, torch.Tensor | None]:
    """Compression (writes the new residual into ``new_state``) and the
    clip scale, applied per leaf by the caller."""
    if cfg.compression == "int8":
        grads, new_state["residual"] = compress_grads(grads,
                                                      state["residual"])
    scale = _clip_scale(grads, cfg.grad_clip) if cfg.grad_clip > 0 else None
    return grads, scale


def _clipped(g: torch.Tensor, scale: torch.Tensor | None) -> torch.Tensor:
    return g if scale is None else g * scale.to(g.dtype)


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------

def make_optimizer(cfg: OptConfig) -> Optimizer:
    if cfg.name == "adamw":
        return _adamw(cfg)
    if cfg.name == "sgd":
        return _sgd(cfg, momentum=0.0)
    if cfg.name == "momentum":
        return _sgd(cfg, momentum=cfg.momentum)
    raise ValueError(f"unknown optimizer {cfg.name!r}")


def _adamw(cfg: OptConfig) -> Optimizer:
    def init(params):
        state = {"m": _zeros_f32(params), "v": _zeros_f32(params),
                 "step": _step0(params)}
        if cfg.compression == "int8":
            state["residual"] = init_residual(params)
        return state

    hyper = dict(lr=cfg.lr, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                 weight_decay=cfg.weight_decay)

    def update(grads, state, params):
        with span("opt.update"):
            step = state["step"] + 1
            new_state: dict = {}
            grads, scale = _prepare(cfg, grads, state, new_state)
            t = step.float()
            bc1 = 1 - torch.pow(cfg.b1, t)
            bc2 = 1 - torch.pow(cfg.b2, t)
            new_p, new_m, new_v = zip(*(
                adamw(g, m, v, p, scale, bc1, bc2, **hyper)
                for g, m, v, p in zip(leaves(grads), leaves(state["m"]),
                                      leaves(state["v"]), leaves(params),
                                      strict=True)))
            new_state.update(m=unflatten(params, new_m),
                             v=unflatten(params, new_v), step=step)
            return unflatten(params, new_p), new_state

    return Optimizer(init, update)


def _sgd(cfg: OptConfig, momentum: float) -> Optimizer:
    def init(params):
        state = {"step": _step0(params)}
        if momentum > 0:
            state["mom"] = _zeros_f32(params)
        if cfg.compression == "int8":
            state["residual"] = init_residual(params)
        return state

    def update(grads, state, params):
        with span("opt.update"):
            new_state: dict = {"step": state["step"] + 1}
            grads, scale = _prepare(cfg, grads, state, new_state)
            if momentum > 0:
                new_mom = tree_map(
                    lambda m, g: momentum * m + _clipped(g, scale).float(),
                    state["mom"], grads)
                new_params = tree_map(
                    lambda p, m: (p.float() - cfg.lr * m).to(p.dtype),
                    params, new_mom)
                new_state["mom"] = new_mom
            else:
                new_params = tree_map(
                    lambda p, g: (p.float() - cfg.lr
                                  * _clipped(g, scale).float()).to(p.dtype),
                    params, grads)
            return new_params, new_state

    return Optimizer(init, update)
