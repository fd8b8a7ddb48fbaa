"""Step-function builders for the training driver (port of the training
half of ``repro.launch.steps``)."""
from __future__ import annotations

from typing import Any, Callable

import torch

from ..core.sync import SyncConfig
from ..models.config import ModelConfig
from ..models.transformer import lm_loss
from ..optim.optimizers import Optimizer
from ..pdb.torch_backend import TrainEngine, make_engine
from ..tree import leaves_with_path, unflatten


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
        lv = leaves_with_path(params)
        paths = [p for p, _ in lv]
        xs = [t.detach().requires_grad_() for _, t in lv]
        loss, metrics = lm_loss(unflatten(paths, xs), batch, cfg,
                                remat=sync.remat)
        if on_metrics is not None:
            on_metrics({k: v.detach() for k, v in metrics.items()})
        gs = torch.autograd.grad(loss, xs, allow_unused=True)
        gs = [torch.zeros_like(x) if g is None else g
              for x, g in zip(xs, gs)]
        return loss.detach(), unflatten(paths, gs)
    return grad_fn


def make_train_engine(cfg: ModelConfig, opt: Optimizer, sync: SyncConfig,
                      params: Any, record_history: bool = False,
                      on_metrics: Callable | None = None) -> TrainEngine:
    """The unified ParameterDB train engine (both sync and delayed paths)
    used by the training driver; see :mod:`repro_torch.pdb.torch_backend`.
    ``on_metrics`` as for :func:`make_lm_grad_fn`."""
    return make_engine(params, make_lm_grad_fn(cfg, sync, on_metrics), opt,
                       sync, record_history=record_history)
