"""Formal model of parameter-database executions (own copy of the parts of
``repro.core.history`` that the training engine's telemetry and its tests
use; paper Secs 3-4).

An *operation* is ``r_i[pi_j][alpha]`` or ``w_i[pi_i][alpha]`` — worker ``i``
reading partition ``j`` (or writing its own partition) during iteration
``alpha``.  A *history* is a total order of operations.  Iterations are
1-based, matching the paper's examples.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

READ = "r"
WRITE = "w"


@dataclasses.dataclass(frozen=True, order=True)
class Op:
    """One database access: ``kind`` in {'r','w'}, by ``worker`` on
    partition ``chunk`` during iteration ``itr``."""

    kind: str
    worker: int
    chunk: int
    itr: int

    def __post_init__(self):
        if self.kind not in (READ, WRITE):
            raise ValueError(f"bad op kind {self.kind!r}")

    def __repr__(self) -> str:  # matches the paper's notation
        return f"{self.kind}{self.worker}[pi{self.chunk}][{self.itr}]"


History = Sequence[Op]


def chunk_projection(h: History, chunk: int) -> list[Op]:
    """The sub-history of ops touching one partition — the unit on which
    the Theorem-5 conditions are defined."""
    return [op for op in h if op.chunk == chunk]


def is_sequentially_correct(h: History, n_workers: int) -> bool:
    """Per-partition conditions from the proof of Theorem 5:
    projecting the history onto any single partition gives (1) no
    inter-iteration interleaving, (2) reads-before-write within an iteration,
    (3) consecutive iterations.

    ``n_workers`` bounds the default chunk range; histories with more
    chunks than workers (one logical worker owning many chunks, as the
    training engine records) are handled by projecting every chunk id that
    actually appears."""
    chunks = set(range(n_workers)) | {op.chunk for op in h}
    for chunk in sorted(chunks):
        proj = chunk_projection(h, chunk)
        cur = 0
        wrote = True  # allows the first iteration to open
        for op in proj:
            if op.itr == cur + 1:
                if not wrote:
                    return False  # previous iteration never wrote this chunk
                cur += 1
                wrote = False
            elif op.itr != cur:
                return False  # skipped or went backwards
            if op.kind == WRITE:
                wrote = True
            elif wrote:
                return False  # read after this iteration's write
    return True
