"""The historical ``*Scheduler`` names of the admission engines (own copy
of the ``repro.core.scheduler`` shim): the consistency policies of
:mod:`repro_torch.pdb.policies` under their old names."""
from __future__ import annotations

from ..pdb.policies import (  # noqa: F401
    BSPPolicy as BSPScheduler,
    BitVectorPolicy as BitVectorScheduler,
    DeltaPolicy as DeltaScheduler,
    Policy as Scheduler,
    SSPPolicy as SSPScheduler,
    make_policy as make_scheduler,
    random_schedule,
)
