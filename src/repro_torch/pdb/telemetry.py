"""Op-history recording and staleness telemetry (own copy of
``repro.pdb.telemetry``'s single-process part).

The training engine funnels every committed step's operations through one
:class:`Telemetry` object, so

  * ``history`` is a :class:`repro_torch.core.history.Op` sequence, and
    ``history.is_sequentially_correct`` is its semantic oracle;
  * staleness is measured uniformly: a read of chunk ``j`` at iteration
    ``alpha`` that observed version ``v`` has staleness ``(alpha - 1) - v``
    (0 under exact RC/WC; positive when reading stale values);
  * the fault-handling layer (``repro_torch.runtime.fault``) reports
    retries and skipped steps into the same object, so one summary
    describes a run.

Mutation is locked: the fault layer may report from another thread.
"""
from __future__ import annotations

import dataclasses
import threading

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
        self.stats = StalenessStats()

    def on_read(self, worker: int, chunk: int, itr: int,
                version: int | None = None) -> None:
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

    def on_write(self, worker: int, chunk: int, itr: int) -> None:
        with self._lock:
            self.stats.writes += 1
            if self.history is not None:
                self.history.append(Op(WRITE, worker, chunk, itr))

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
