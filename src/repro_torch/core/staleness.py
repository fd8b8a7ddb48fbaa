"""The historical entry points of the delta-staleness engine (own copy of
the ``repro.core.staleness`` shim): the device ring buffer of
:mod:`repro_torch.pdb.torch_backend` under its old module name."""
from __future__ import annotations

from ..pdb.torch_backend import (  # noqa: F401
    DelayedState,
    PyTree,
    init_delayed_state,
    make_delayed_step,
)
