"""The distributed ParameterDB of the port (own copy of
``repro.pdb.server``): one consistency layer, many processes.

  * :mod:`protocol` — the wire format (length-prefixed JSON header + raw
    array payload frames, byte for byte the JAX package's) and the
    Knuth-hash chunk -> shard placement;
  * :mod:`shard` — one server process owning a subset of the chunks as
    torch CPU tensors: authoritative chunk-local policy state, blocking
    admission on a condition variable, Lamport-stamped Op recording, dedup
    of client retries, optional snapshot/restore for crash survival;
  * :mod:`client` — the worker-side :class:`ClientParameterDB`: versioned
    local cache with policy-bounded admissibility, vector-clock gossip
    that makes BSP barriers and SSP slack exact across shards, and
    reconnect-with-backoff so a killed-and-restarted shard is survivable;
  * :mod:`cluster` — spawn/init/kill/restart orchestration plus
    ``pull()``, which reassembles the global chunk values, the merged
    Op history and the folded staleness counters from every shard.

Where :class:`~repro_torch.pdb.db.InProcessParameterDB` raises and
:class:`~repro_torch.pdb.db.ThreadedParameterDB` blocks a thread, a shard
blocks the *handler* thread of whichever connection issued the op —
admission semantics are decided by the same policy predicates in all
three.  A port peer and a JAX peer (shard or client) interoperate.
"""
from .client import CacheEntry, ClientParameterDB
from .cluster import (DistributedRunStats, PullResult, ShardCluster,
                      run_distributed_lr, smoke)
from .protocol import owned_chunks, shard_of
from .shard import ShardConfig, ShardServer, ShardState

__all__ = [
    "CacheEntry",
    "ClientParameterDB",
    "DistributedRunStats",
    "PullResult",
    "ShardCluster",
    "ShardConfig",
    "ShardServer",
    "ShardState",
    "owned_chunks",
    "run_distributed_lr",
    "shard_of",
    "smoke",
]
