"""Optimizers and schedules of the port (own copy of ``repro.optim``)."""
from .optimizers import (OptConfig, Optimizer, clip_by_global_norm,  # noqa: F401
                         compress_grads, global_norm, init_residual,
                         make_optimizer)
from . import schedules  # noqa: F401
