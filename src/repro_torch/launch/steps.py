"""Step-function builders (port of ``repro.launch.steps``): the training
step, the ParameterDB train engine's gradient function and engine, and
the prefill and decode steps over the dense cache.

The steps run on plain tensors or, sharded, on DTensors laid out by
:mod:`repro_torch.launch.sharding` (the sync mode's rules); ``act_specs``
(``launch/dryrun.make_act_specs``) pins the activations' layouts at JAX's
points.  The step code is the same for every sync mode: the mode is the
parameters' layout, and the gradients are laid out as their parameters
(JAX's ``out_shardings``), so ``bsp`` writes by an all-reduce over
``data`` and ``datacentric``/``ssp`` by a reduce-scatter."""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor

from ..core.sync import SyncConfig
from ..device import replicated
from ..models.config import ModelConfig
from ..models.transformer import decode_step as model_decode
from ..models.transformer import lm_loss, prefill
from ..optim.optimizers import Optimizer
from ..pdb.torch_backend import TrainEngine, make_engine
from ..trace import span
from ..tree import leaves, unflatten


def make_train_step(cfg: ModelConfig, opt: Optimizer, sync: SyncConfig,
                    act_specs: dict | None = None) -> Callable:
    """train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): ``lm_loss``'s gradients under ``sync.remat``, then
    ``opt.update``; metrics as ``lm_loss`` gives them (detached).  The
    parameters are not updated in place: the step returns new trees, as
    JAX's does."""
    metrics: dict = {}
    grad_fn = make_lm_grad_fn(cfg, sync, on_metrics=metrics.update,
                              act_specs=act_specs)

    def train_step(params, opt_state, batch):
        _, grads = grad_fn(params, batch)
        new_params, new_opt = opt.update(grads, opt_state, params)
        return new_params, new_opt, dict(metrics)
    return train_step


def make_lm_grad_fn(cfg: ModelConfig, sync: SyncConfig,
                    on_metrics: Callable | None = None,
                    act_specs: dict | None = None) -> Callable:
    """grad_fn(params, batch) -> (loss, grads) over the LM loss, the
    counterpart of ``jax.value_and_grad(lm_loss)``.  Each parameter leaf
    is detached (an alias, no copy) and made a leaf of the graph, so the
    gradients come back per leaf, in the parameters' dtypes.  The value
    differentiated is ``lm_loss``'s total (with the MoE router's losses);
    ``on_metrics``, when given, receives each call's metrics (detached
    device scalars: ``loss``, ``total_loss``, ``lb_loss``,
    ``router_entropy``), which JAX's ``has_aux`` returns and its engine
    drops.  On DTensor parameters the loss and metrics come back
    replicated and each gradient in its parameter's placements."""

    def grad_fn(params, batch):
        with span("model.grad"):
            xs = [t.detach().requires_grad_() for t in leaves(params)]
            loss, metrics = lm_loss(unflatten(params, xs), batch, cfg,
                                    remat=sync.remat, act_specs=act_specs)
            loss = replicated(loss)
            if on_metrics is not None:
                on_metrics({k: replicated(v.detach())
                            for k, v in metrics.items()})
            gs = torch.autograd.grad(loss, xs, allow_unused=True)
            gs = [torch.zeros_like(x) if g is None else g
                  for x, g in zip(xs, gs)]
            gs = [g.redistribute(x.device_mesh, x.placements)
                  if isinstance(g, DTensor) else g for x, g in zip(xs, gs)]
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
                      remat: str = "none",
                      act_specs: dict | None = None) -> Callable:
    """prefill_step(params, batch) -> (last-position logits (B, V), dense
    cache); batch: {"tokens": (B, S)}, and the vision model's "media"."""
    def prefill_step(params, batch):
        return prefill(params, batch["tokens"], cfg, cache_len=cache_len,
                       remat=remat, media=batch.get("media"),
                       act_specs=act_specs)
    return prefill_step


def make_decode_step(cfg: ModelConfig,
                     act_specs: dict | None = None) -> Callable:
    """serve_step(params, cache, batch) -> (logits (B, 1, V), cache);
    batch: {"tokens": (B, 1), "pos": a scalar or (B,)}, and the vision
    model's "media".  The cache is updated in place (``decode_step``)."""
    def serve_step(params, cache, batch):
        return model_decode(params, cache, batch["tokens"], batch["pos"],
                            cfg, media=batch.get("media"),
                            act_specs=act_specs)
    return serve_step
