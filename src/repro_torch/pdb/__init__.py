"""The parameter database of the port: the device ring-buffer engine
(``torch_backend``) and its Op-history / staleness telemetry
(``telemetry``, own copy of ``repro.pdb.telemetry``)."""
from .telemetry import StalenessStats, Telemetry, summarize  # noqa: F401
from .torch_backend import (DelayedState, TrainEngine,  # noqa: F401
                            init_delayed_state, make_delayed_step,
                            make_engine)
