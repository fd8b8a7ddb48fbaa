"""Op-history recording and staleness telemetry (own copy of
``repro.pdb.telemetry``).

The training engine, the stores of :mod:`repro_torch.pdb.db`, the shards
of :mod:`repro_torch.pdb.server` and ``serve.live_db.LiveParamDB`` funnel
their operations through one :class:`Telemetry` object, so

  * ``history`` is a :class:`repro_torch.core.history.Op` sequence, and
    ``history.is_sequentially_correct`` is its semantic oracle;
  * staleness is measured uniformly: a read of chunk ``j`` at iteration
    ``alpha`` that observed version ``v`` has staleness ``(alpha - 1) - v``
    (0 under exact RC/WC; positive when reading stale values; negative when
    a racy policy such as SSP or Hogwild read *ahead* of the sequential
    schedule);
  * the fault-handling layer (``repro_torch.runtime.fault``) reports
    retries and skipped steps into the same object, so one summary
    describes a run.

Mutation is locked: the threaded store calls in under its own lock, and
the fault layer may report from another thread.

Distributed runs produce *one Telemetry per shard*.  Each shard stamps its
ops with a Lamport clock (monotone per shard, merged across processes via
the RPC layer), and :func:`merge_timed_histories` reassembles the global Op
history by a causality-consistent total order — per-shard order is
preserved, so per-chunk projections (what
``repro_torch.core.history.is_sequentially_correct`` inspects) are exactly
the shard-local orders.  :func:`merge_stats` folds the per-shard staleness
counters into one :class:`StalenessStats`.
"""
from __future__ import annotations

import dataclasses
import heapq
import threading
from typing import Iterable, Sequence

from ..core.history import READ, WRITE, Op


@dataclasses.dataclass
class StalenessStats:
    reads: int = 0
    writes: int = 0
    observed_reads: int = 0       # reads that reported a version
    stale_reads: int = 0          # reads with staleness > 0
    ahead_reads: int = 0          # reads with staleness < 0 (racy policies)
    max_staleness: float = float("-inf")   # over observed reads only
    min_staleness: float = float("inf")
    sum_staleness: float = 0.0
    retried_steps: int = 0
    skipped_steps: int = 0

    @property
    def mean_staleness(self) -> float:
        return (self.sum_staleness / self.observed_reads
                if self.observed_reads else 0.0)


class Telemetry:
    """Op history (optional) + staleness counters."""

    def __init__(self, record_history: bool = False):
        self._lock = threading.Lock()
        self.history: list | None = [] if record_history else None
        self.lamports: list[int] | None = [] if record_history else None
        self.stats = StalenessStats()

    # Telemetry objects cross process boundaries in the sharded backend
    # (snapshot/restore); locks don't pickle.
    def __getstate__(self) -> dict:
        state = self.__dict__.copy()
        del state["_lock"]
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def on_read(self, worker: int, chunk: int, itr: int,
                version: int | None = None,
                lamport: int | None = None) -> None:
        with self._lock:
            s = self.stats
            s.reads += 1
            if version is not None:
                s.observed_reads += 1
                staleness = (itr - 1) - version
                s.sum_staleness += staleness
                s.max_staleness = max(s.max_staleness, staleness)
                s.min_staleness = min(s.min_staleness, staleness)
                if staleness > 0:
                    s.stale_reads += 1
                elif staleness < 0:
                    s.ahead_reads += 1
            if self.history is not None:
                self.history.append(Op(READ, worker, chunk, itr))
                self.lamports.append(lamport if lamport is not None
                                     else len(self.lamports))

    def on_write(self, worker: int, chunk: int, itr: int,
                 lamport: int | None = None) -> None:
        with self._lock:
            self.stats.writes += 1
            if self.history is not None:
                self.history.append(Op(WRITE, worker, chunk, itr))
                self.lamports.append(lamport if lamport is not None
                                     else len(self.lamports))

    def timed_history(self) -> list[tuple[int, object]]:
        """``[(lamport, Op), ...]`` in recording order (for merging)."""
        if self.history is None:
            return []
        with self._lock:
            return list(zip(self.lamports, self.history))

    def on_retry(self, step: int) -> None:
        with self._lock:
            self.stats.retried_steps += 1

    def on_skip(self, step: int) -> None:
        with self._lock:
            self.stats.skipped_steps += 1

    def summary(self) -> dict:
        return summarize(self.stats)


def summarize(s: StalenessStats) -> dict:
    seen = s.observed_reads > 0
    return {
        "reads": s.reads, "writes": s.writes,
        "stale_reads": s.stale_reads, "ahead_reads": s.ahead_reads,
        "max_staleness": s.max_staleness if seen else 0.0,
        "min_staleness": s.min_staleness if seen else 0.0,
        "mean_staleness": s.mean_staleness,
        "retried_steps": s.retried_steps,
        "skipped_steps": s.skipped_steps,
    }


# ---------------------------------------------------------------------------
# Cross-shard merging (the distributed backend's telemetry reassembly)
# ---------------------------------------------------------------------------

def merge_timed_histories(
        parts: Sequence[Sequence[tuple[int, object]]]) -> list:
    """Reassemble one global Op history from per-shard Lamport-stamped
    histories.

    Ops are totally ordered by ``(lamport, shard_index, arrival_index)``.
    Lamport stamps are strictly increasing within a shard, so the merge
    preserves every shard's local order — and since each chunk is owned by
    exactly one shard, every per-chunk projection of the merged history
    equals its shard-local projection.  That makes the merge *sound* for
    ``repro_torch.core.history.is_sequentially_correct``, whose conditions are
    per-chunk; the Lamport order additionally respects cross-shard
    causality carried by the RPC clock exchange.
    """
    streams = [
        [(ts, shard_idx, seq, op) for seq, (ts, op) in enumerate(part)]
        for shard_idx, part in enumerate(parts)
    ]
    return [op for _, _, _, op in heapq.merge(*streams)]


def merge_stats(parts: Iterable[StalenessStats]) -> StalenessStats:
    """Fold per-shard staleness counters into one global StalenessStats."""
    out = StalenessStats()
    for s in parts:
        out.reads += s.reads
        out.writes += s.writes
        out.observed_reads += s.observed_reads
        out.stale_reads += s.stale_reads
        out.ahead_reads += s.ahead_reads
        out.max_staleness = max(out.max_staleness, s.max_staleness)
        out.min_staleness = min(out.min_staleness, s.min_staleness)
        out.sum_staleness += s.sum_staleness
        out.retried_steps += s.retried_steps
        out.skipped_steps += s.skipped_steps
    return out
