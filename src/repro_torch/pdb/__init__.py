"""The parameter database of the port (own copy of ``repro.pdb``): one
consistency layer, four backends.

  policies       — BSP barriers (Alg 2a), Sec-5 RC/WC bit vector, Sec-7.1
                   delta admissible delay (uniform or per-chunk), SSP and
                   value-bounded staleness on per-worker vector clocks
  db             — in-process store (raises on inadmissible ops) and
                   blocking-threaded store (one condition variable), chunks
                   as torch tensors on one device
  torch_backend  — device ring buffer of the last delta+1 parameter
                   versions + the TrainEngine behind repro_torch.launch.train
  telemetry      — shared Op-history recording and staleness statistics;
                   Lamport stamps, per-shard history and counter merges
  server         — the multi-process sharded store (:mod:`.server`): shard
                   processes holding CPU chunks, worker clients with
                   caches, clock gossip and retries; JAX's wire protocol

Every backend emits the same :class:`repro_torch.core.history.Op` history,
so ``repro_torch.core.history.is_sequentially_correct`` is the semantic
oracle for all of them.
"""
from .db import (InProcessParameterDB, InadmissibleOp, ParameterDB,  # noqa: F401
                 ThreadedParameterDB, WaitTimeout, run_interleaved,
                 stall_diagnostic)
from .policies import (POLICIES, BSPPolicy, BitVectorPolicy, DeltaPolicy,  # noqa: F401
                       Policy, SSPPolicy, ValueBoundPolicy, VectorClocks,
                       make_policy, random_schedule,
                       ssp_clock_bound_violations)
from .telemetry import (StalenessStats, Telemetry, merge_stats,  # noqa: F401
                        merge_timed_histories, summarize)
from .torch_backend import (DelayedState, TrainEngine,  # noqa: F401
                            init_delayed_state, make_delayed_step,
                            make_engine)
