"""Step-function builders (port of ``repro.launch.steps``): the training
step, the ParameterDB train engine's gradient function and engine, and
the prefill and decode steps over the dense cache."""
from __future__ import annotations

from typing import Any, Callable

import torch

from ..core.sync import SyncConfig
from ..models.config import ModelConfig
from ..models.transformer import decode_step as model_decode
from ..models.transformer import lm_loss, prefill
from ..optim.optimizers import Optimizer
from ..pdb.torch_backend import TrainEngine, make_engine
from ..tree import leaves, unflatten


def make_train_step(cfg: ModelConfig, opt: Optimizer,
                    sync: SyncConfig) -> Callable:
    """train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): ``lm_loss``'s gradients under ``sync.remat``, then
    ``opt.update``; metrics as ``lm_loss`` gives them (detached).  The
    parameters are not updated in place: the step returns new trees, as
    JAX's does."""
    metrics: dict = {}
    grad_fn = make_lm_grad_fn(cfg, sync, on_metrics=metrics.update)

    def train_step(params, opt_state, batch):
        _, grads = grad_fn(params, batch)
        new_params, new_opt = opt.update(grads, opt_state, params)
        return new_params, new_opt, dict(metrics)
    return train_step


def make_lm_grad_fn(cfg: ModelConfig, sync: SyncConfig,
                    on_metrics: Callable | None = None) -> Callable:
    """grad_fn(params, batch) -> (loss, grads) over the LM loss, the
    counterpart of ``jax.value_and_grad(lm_loss)``.  Each parameter leaf
    is detached (an alias, no copy) and made a leaf of the graph, so the
    gradients come back per leaf, in the parameters' dtypes.  The value
    differentiated is ``lm_loss``'s total (with the MoE router's losses);
    ``on_metrics``, when given, receives each call's metrics (detached
    device scalars: ``loss``, ``total_loss``, ``lb_loss``,
    ``router_entropy``), which JAX's ``has_aux`` returns and its engine
    drops."""

    def grad_fn(params, batch):
        xs = [t.detach().requires_grad_() for t in leaves(params)]
        loss, metrics = lm_loss(unflatten(params, xs), batch, cfg,
                                remat=sync.remat)
        if on_metrics is not None:
            on_metrics({k: v.detach() for k, v in metrics.items()})
        gs = torch.autograd.grad(loss, xs, allow_unused=True)
        gs = [torch.zeros_like(x) if g is None else g
              for x, g in zip(xs, gs)]
        return loss.detach(), unflatten(params, gs)
    return grad_fn


def make_train_engine(cfg: ModelConfig, opt: Optimizer, sync: SyncConfig,
                      params: Any, record_history: bool = False,
                      on_metrics: Callable | None = None) -> TrainEngine:
    """The unified ParameterDB train engine (both sync and delayed paths)
    used by the training driver; see :mod:`repro_torch.pdb.torch_backend`.
    ``on_metrics`` as for :func:`make_lm_grad_fn`."""
    return make_engine(params, make_lm_grad_fn(cfg, sync, on_metrics), opt,
                       sync, record_history=record_history)


def make_prefill_step(cfg: ModelConfig, cache_len: int,
                      remat: str = "none") -> Callable:
    """prefill_step(params, batch) -> (last-position logits (B, V), dense
    cache); batch: {"tokens": (B, S)}, and the vision model's "media"."""
    def prefill_step(params, batch):
        return prefill(params, batch["tokens"], cfg, cache_len=cache_len,
                       remat=remat, media=batch.get("media"))
    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """serve_step(params, cache, batch) -> (logits (B, 1, V), cache);
    batch: {"tokens": (B, 1), "pos": a scalar or (B,)}, and the vision
    model's "media".  The cache is updated in place (``decode_step``)."""
    def serve_step(params, cache, batch):
        return model_decode(params, cache, batch["tokens"], batch["pos"],
                            cfg, media=batch.get("media"))
    return serve_step
