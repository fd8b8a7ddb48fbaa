"""Consistency policies of the parameter database (own copy of
``repro.pdb.policies``; paper Secs 4-5, 7.1).

A *policy* is the pure-bookkeeping admission engine behind every execution
backend: ``can_read / can_write`` test whether a Def-3 operation is
admissible right now, ``did_read / did_write`` record its completion.
Policies never block and never hold values — backends
(``repro_torch.pdb.db``, the simulator; in the JAX package also its
multi-process server shards) compose a policy with storage.  The logic is
the JAX package's line for line, so every admission decision is the same.

Every policy carries a first-class :class:`VectorClocks` — per-worker
``commit`` (last iteration whose write the worker committed) and
``frontier`` (last iteration whose *full read set* the worker completed).
The clock vectors are the state that must travel between processes in the
sharded parameter-server backend: chunk-local state (bit vectors, version
numbers, last-read arrays) stays at the shard that owns the chunk, while
clock-gated admission (BSP barriers, SSP slack) is evaluated against the
local clock vector, which is a *lower bound* of the true global clocks.
All admission predicates here are monotone in the clocks, so evaluating
them against a lower bound is safe — a remote shard or a caching client
can only be conservative, never admit an op the true state would reject.

  * :class:`BitVectorPolicy` — the Sec-5 protocol verbatim: one bit per
    worker per chunk gates writes; a per-chunk iteration number gates reads.
    Enforces exact sequential semantics (delta = 0).  Chunk-local.
  * :class:`DeltaPolicy`     — the Sec-7.1 revised protocol: per-chunk
    last-read iteration arrays; admissible delay ``delta >= 0``, uniform or
    per-chunk.  ``delta=0`` coincides with :class:`BitVectorPolicy`;
    ``delta=inf`` degenerates to Hogwild!-style fully asynchronous
    execution.  Chunk-local.
  * :class:`BSPPolicy`       — the Algorithm-2a baseline: global read and
    write barriers expressed over the clock vectors (``min commit`` gates
    reads, ``min frontier`` gates writes).
  * :class:`SSPPolicy`       — stale-synchronous-parallel (Petuum / Cipar /
    Ho et al.): per-worker commit clocks; a worker may read at iteration
    ``alpha`` only if the slowest worker's clock is within ``slack``.
    Writes are never gated, so SSP does *not* satisfy WC — it bounds
    divergence instead of eliminating it (the regime the paper positions
    itself against).
  * :class:`ValueBoundPolicy` — the value-bounded model of Dai et al.
    (2014): operations are never clock-gated (``delta=inf``), but a served
    value must be within ``vbound`` accumulated update magnitude of the
    freshest committed value.  The magnitude ledger lives with the storage
    (the server shard tracks per-chunk cumulative change), so
    ``cache_admissible`` is always False here: a cached value must be
    *validated* against the owner shard, which answers not-modified when
    the drift is within bound.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Protocol, Sequence


@dataclasses.dataclass
class VectorClocks:
    """Per-worker progress clocks: the only cross-shard policy state.

    ``commit[i]``   — last iteration whose write worker ``i`` committed.
    ``frontier[i]`` — last iteration for which worker ``i`` completed its
                      full Def-3 read set (all chunks read at that itr).

    Both vectors are monotone; ``observe_*`` merge remote knowledge by
    elementwise max, so any local copy is a lower bound of the truth.
    """

    commit: list[int]
    frontier: list[int]

    @classmethod
    def zero(cls, n_workers: int) -> "VectorClocks":
        return cls([0] * n_workers, [0] * n_workers)

    def observe_commit(self, worker: int, itr: int) -> None:
        self.commit[worker] = max(self.commit[worker], itr)

    def observe_frontier(self, worker: int, itr: int) -> None:
        self.frontier[worker] = max(self.frontier[worker], itr)

    def merge(self, commit: Sequence[int], frontier: Sequence[int]) -> None:
        for i, v in enumerate(commit):
            self.commit[i] = max(self.commit[i], v)
        for i, v in enumerate(frontier):
            self.frontier[i] = max(self.frontier[i], v)

    @property
    def min_commit(self) -> int:
        return min(self.commit)

    @property
    def min_frontier(self) -> int:
        return min(self.frontier)

    def as_dict(self) -> dict:
        return {"commit": list(self.commit), "frontier": list(self.frontier)}


class Policy(Protocol):
    def can_read(self, worker: int, chunk: int, itr: int) -> bool: ...
    def can_write(self, worker: int, chunk: int, itr: int) -> bool: ...
    def did_read(self, worker: int, chunk: int, itr: int) -> None: ...
    def did_write(self, worker: int, chunk: int, itr: int) -> None: ...


class BasePolicy:
    """Shared clock bookkeeping: every concrete policy owns VectorClocks."""

    name = "base"
    sequential_at_zero = False

    def __init__(self, n_workers: int, n_chunks: int | None = None):
        self.p = n_workers
        self.m = n_chunks if n_chunks is not None else n_workers
        self.clocks = VectorClocks.zero(n_workers)

    # -- remote clock observation (server shards, caching clients) ----------
    def observe_commit(self, worker: int, itr: int) -> None:
        self.clocks.observe_commit(worker, itr)

    def observe_frontier(self, worker: int, itr: int) -> None:
        self.clocks.observe_frontier(worker, itr)

    # -- client-side cache admissibility ------------------------------------
    def cache_admissible(self, chunk: int, cached_version: int,
                         itr: int) -> bool:
        """May a read ``r[chunk][itr]`` be served from a locally cached
        value at ``cached_version``, given only this instance's (lower
        bound) clock knowledge?  Default: never."""
        return False

    # -- stall diagnostics ---------------------------------------------------
    def describe(self, worker: int, chunk: int, itr: int) -> str:
        """Compact state relevant to the admission of one op, for timeout
        diagnostics."""
        c = self.clocks
        return f"commit={c.commit} frontier={c.frontier}"

    def did_read(self, worker: int, chunk: int, itr: int) -> None:
        pass

    def did_write(self, worker: int, chunk: int, itr: int) -> None:
        self.clocks.observe_commit(worker, itr)


class BitVectorPolicy(BasePolicy):
    """Sec 5: 'a write on pi_i can be executed if this chunk has been read by
    all the worker processes in their alpha-th iterations' (bit vector), and
    'a read [at alpha+1] can be executed if [the chunk's] iteration number is
    one less than the iteration number in the read operation'.

    All admission state is chunk-local, so the sharded server backend needs
    no cross-shard traffic to run this policy exactly."""

    name = "dc"
    sequential_at_zero = True

    def __init__(self, n_workers: int, n_chunks: int | None = None):
        super().__init__(n_workers, n_chunks)
        # start as if freshly written (version 0, bits zeroed): iteration-1
        # writes must wait for every worker's iteration-1 read of the chunk
        self.bits = [[False] * self.p for _ in range(self.m)]
        self.version = [0] * self.m  # iteration number of last executed write

    def can_read(self, worker: int, chunk: int, itr: int) -> bool:
        return self.version[chunk] == itr - 1

    def did_read(self, worker: int, chunk: int, itr: int) -> None:
        self.bits[chunk][worker] = True

    def can_write(self, worker: int, chunk: int, itr: int) -> bool:
        return all(self.bits[chunk])

    def did_write(self, worker: int, chunk: int, itr: int) -> None:
        self.bits[chunk] = [False] * self.p  # 'all bits are set to zero'
        self.version[chunk] = itr
        self.clocks.observe_commit(worker, itr)

    def cache_admissible(self, chunk: int, cached_version: int,
                         itr: int) -> bool:
        # exact: the chunk's version cannot pass itr-1 before *this* read
        # is recorded, so a cached itr-1 value is provably current
        return cached_version == itr - 1

    def describe(self, worker: int, chunk: int, itr: int) -> str:
        return (f"version[{chunk}]={self.version[chunk]} "
                f"bits[{chunk}]={self.bits[chunk]} "
                f"{super().describe(worker, chunk, itr)}")


class DeltaPolicy(BasePolicy):
    """Sec 7.1: per-chunk last-read iteration array + chunk version.

    Read  r_i[pi_j][alpha] admissible iff version[j] >= alpha - 1 - delta_j.
    Write w_i[pi_i][alpha] admissible iff min_k last_read[i][k] >= alpha - delta_i.

    ``delta`` may be a scalar (uniform admissible delay) or a per-chunk
    sequence — the per-partition-group delays of Sec 7.1 (and of
    ``SyncConfig.group_delays`` on the training engine).  Chunk-local.
    """

    name = "dc-array"
    sequential_at_zero = True

    def __init__(self, n_workers: int, delta: float | Sequence[float] = 0,
                 n_chunks: int | None = None):
        if isinstance(delta, (int, float)):
            m = n_chunks if n_chunks is not None else n_workers
            deltas = [delta] * m
        else:
            deltas = list(delta)
            m = n_chunks if n_chunks is not None else len(deltas)
            if len(deltas) != m:
                raise ValueError("per-chunk delta length != n_chunks")
        super().__init__(n_workers, m)
        if any(d < 0 for d in deltas):
            raise ValueError("delta must be >= 0")
        self.deltas = deltas
        self.version = [0] * self.m
        self.last_read = [[0] * self.p for _ in range(self.m)]

    @property
    def delta(self) -> float:
        """The uniform delay (max over chunks for heterogeneous configs)."""
        return max(self.deltas)

    def can_read(self, worker: int, chunk: int, itr: int) -> bool:
        return self.version[chunk] >= itr - 1 - self.deltas[chunk]

    def did_read(self, worker: int, chunk: int, itr: int) -> None:
        self.last_read[chunk][worker] = max(self.last_read[chunk][worker], itr)

    def can_write(self, worker: int, chunk: int, itr: int) -> bool:
        return min(self.last_read[chunk]) >= itr - self.deltas[chunk]

    def did_write(self, worker: int, chunk: int, itr: int) -> None:
        self.version[chunk] = max(self.version[chunk], itr)
        self.clocks.observe_commit(worker, itr)

    def cache_admissible(self, chunk: int, cached_version: int,
                         itr: int) -> bool:
        # the true version only advances, so a cached version satisfying the
        # bound stays admissible; infinite delay (hogwild) disables caching
        # entirely — an unsynchronized worker should keep observing fresh
        # values, not iterate on its first fetch forever
        d = self.deltas[chunk]
        return math.isfinite(d) and cached_version >= itr - 1 - d

    @property
    def hogwild(self) -> bool:
        return all(math.isinf(d) for d in self.deltas)

    def describe(self, worker: int, chunk: int, itr: int) -> str:
        return (f"version[{chunk}]={self.version[chunk]} "
                f"last_read[{chunk}]={self.last_read[chunk]} "
                f"delta[{chunk}]={self.deltas[chunk]} "
                f"{super().describe(worker, chunk, itr)}")


class BSPPolicy(BasePolicy):
    """Algorithm 2a expressed over the per-worker clock vectors.

    Read barrier:  no read of iteration alpha+1 until *every* worker's write
    of iteration alpha has executed — ``min commit >= alpha``.
    Write barrier: no write of iteration alpha until *every* worker has
    finished *all* its reads of iteration alpha — ``min frontier >= alpha``.

    The frontier clock advances locally when ``did_read`` completes a
    worker's read set; in the sharded backend (where one shard sees only
    its own chunks' reads) it advances via ``observe_frontier`` broadcasts
    instead.
    """

    name = "bsp"
    sequential_at_zero = True

    def __init__(self, n_workers: int, n_chunks: int | None = None):
        super().__init__(n_workers, n_chunks)
        self.reads_done = [[0] * self.m for _ in range(self.p)]
        # reads_done[i][j] = last iter in which worker i read chunk j

    def can_read(self, worker: int, chunk: int, itr: int) -> bool:
        return self.clocks.min_commit >= itr - 1

    def did_read(self, worker: int, chunk: int, itr: int) -> None:
        self.reads_done[worker][chunk] = max(self.reads_done[worker][chunk],
                                             itr)
        self.clocks.observe_frontier(worker, min(self.reads_done[worker]))

    def can_write(self, worker: int, chunk: int, itr: int) -> bool:
        return self.clocks.min_frontier >= itr

    def did_write(self, worker: int, chunk: int, itr: int) -> None:
        self.clocks.observe_commit(worker, itr)

    def cache_admissible(self, chunk: int, cached_version: int,
                         itr: int) -> bool:
        # under BSP every iteration-alpha read observes version alpha-1
        # exactly; min_commit is a lower bound, so this is conservative
        return cached_version == itr - 1 and self.clocks.min_commit >= itr - 1


class SSPPolicy(BasePolicy):
    """Stale synchronous parallel: per-worker commit clocks, bounded
    divergence.

    A read at iteration ``alpha`` is admissible iff
    ``min commit >= alpha - 1 - slack`` (the fastest worker is at most
    ``slack`` iterations ahead of the slowest); writes are never gated.
    ``slack=0`` is BSP's read barrier *without* the write barrier —
    histories are clock-bounded but not sequentially correct, which is
    exactly the contrast the paper draws with RC/WC.
    """

    name = "ssp"
    sequential_at_zero = False

    def __init__(self, n_workers: int, slack: float = 0,
                 n_chunks: int | None = None):
        if slack < 0:
            raise ValueError("slack must be >= 0")
        super().__init__(n_workers, n_chunks)
        self.slack = slack

    @property
    def clock(self) -> list[int]:
        """Back-compat alias: the per-worker commit clock vector."""
        return self.clocks.commit

    def can_read(self, worker: int, chunk: int, itr: int) -> bool:
        return self.clocks.min_commit >= itr - 1 - self.slack

    def can_write(self, worker: int, chunk: int, itr: int) -> bool:
        return True

    def cache_admissible(self, chunk: int, cached_version: int,
                         itr: int) -> bool:
        # serve a cached value only if it is itself within the clock bound
        # (exact clock-bounded staleness: the *served version*, not just the
        # op order, respects the slack), and the bound admits the read at all
        return (math.isfinite(self.slack)
                and cached_version >= itr - 1 - self.slack
                and self.clocks.min_commit >= itr - 1 - self.slack)

    def describe(self, worker: int, chunk: int, itr: int) -> str:
        return f"slack={self.slack} {super().describe(worker, chunk, itr)}"


class ValueBoundPolicy(DeltaPolicy):
    """Value-bounded staleness (Dai et al. 2014): clock-free admission with
    a bound on the *magnitude* of unseen updates.

    Ops are never gated (``delta=inf``); the guarantee is enforced where
    the values live: the owner shard keeps a per-chunk cumulative-update
    ledger (sum of L-inf write deltas) and serves a cached value only while
    its drift stays within ``vbound``.  ``cache_admissible`` is therefore
    always False — the client must *validate* with the shard, which answers
    not-modified (no payload) when the bound holds.
    """

    name = "vap"
    sequential_at_zero = False

    def __init__(self, n_workers: int, vbound: float = 0.0,
                 n_chunks: int | None = None):
        if vbound < 0:
            raise ValueError("vbound must be >= 0")
        super().__init__(n_workers, math.inf, n_chunks)
        self.vbound = vbound

    def cache_admissible(self, chunk: int, cached_version: int,
                         itr: int) -> bool:
        return False     # value bounds are checked against the ledger

    def describe(self, worker: int, chunk: int, itr: int) -> str:
        return f"vbound={self.vbound} {super().describe(worker, chunk, itr)}"


POLICIES = ("bsp", "dc", "dc-array", "ssp", "hogwild", "vap")


def make_policy(policy: str, n_workers: int,
                delta: float | Sequence[float] = 0,
                n_chunks: int | None = None,
                vbound: float | None = None) -> Policy:
    """The single policy factory shared by every backend (threads, in-process
    replay, discrete-event simulator)."""
    if policy == "bsp":
        return BSPPolicy(n_workers, n_chunks)
    if policy == "dc":
        if isinstance(delta, (int, float)) and delta == 0:
            return BitVectorPolicy(n_workers, n_chunks)
        return DeltaPolicy(n_workers, delta, n_chunks)
    if policy == "dc-array":  # Sec-7.1 engine even at delta=0
        return DeltaPolicy(n_workers, delta, n_chunks)
    if policy == "hogwild":
        return DeltaPolicy(n_workers, math.inf, n_chunks)
    if policy == "ssp":
        return SSPPolicy(n_workers, delta, n_chunks)
    if policy == "vap":
        bound = vbound if vbound is not None else delta
        return ValueBoundPolicy(n_workers, bound, n_chunks)
    raise ValueError(f"unknown policy {policy!r}")


def random_schedule(policy: str, n_workers: int, n_iters: int,
                    seed: int = 0, delta: float = 0) -> list:
    """Generate a random admissible execution history: at every step pick a
    uniformly random worker whose next Def-3 operation is admissible under
    the policy.  Used by the hypothesis property tests (every RC/WC history
    must be sequentially correct — Theorems 1/2), by the SSP clock-bound
    property test, and as a fuzzer for the admission engines (total progress
    = deadlock freedom).

    Implemented as the in-process ParameterDB backend driven with dummy
    values — one admissible-move loop (``run_interleaved``) serves both
    the fuzzer and the value-carrying conformance runs."""
    import torch

    from .db import InProcessParameterDB, run_interleaved

    zero = torch.zeros(1)
    db = InProcessParameterDB(
        [zero] * n_workers, n_workers,
        policy=make_policy(policy, n_workers, delta), record=True)
    run_interleaved(db, n_iters, lambda worker, snap, itr: zero, seed=seed)
    return db.history


def ssp_clock_bound_violations(history, n_workers: int, slack: float) -> list:
    """Replay a history against per-worker clocks and return every read that
    observed a clock gap larger than ``slack`` — empty iff the history
    respects the SSP bound."""
    from ..core.history import READ, WRITE

    clock = [0] * n_workers
    bad = []
    for op in history:
        if op.kind == READ:
            if (op.itr - 1) - min(clock) > slack:
                bad.append(op)
        elif op.kind == WRITE:
            clock[op.worker] = max(clock[op.worker], op.itr)
    return bad
