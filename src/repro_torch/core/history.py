"""Formal model of parameter-database executions (own copy of
``repro.core.history``; paper Secs 3-4, 9).

An *operation* is ``r_i[pi_j][alpha]`` or ``w_i[pi_i][alpha]`` — worker ``i``
reading partition ``j`` (or writing its own partition) during iteration
``alpha``.  A *history* is a total order of operations.  This module provides

  * predicate checkers for the paper's barrier constraints (BSP, Sec 4.3),
    the relaxed read/write constraints (RC/WC, Sec 4.4) and their
    delta-admissible-delay forms (Sec 7);
  * the Definition-4 sequential-ML-computation checker (global form) and the
    per-partition correctness conditions used in the proof of Theorem 5;
  * a small interpreter that *executes* a history against a numeric
    fixed-point computation and compares the outcome with sequential
    execution — the semantic (not just syntactic) correctness check.

It is host bookkeeping that holds no tensors: the interpreter stays numpy
f64, so its decisions and results are the JAX package's exactly.
Iterations are 1-based, matching the paper's examples (Figs 1 and 3).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Iterable, Sequence

import numpy as np

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


def r(worker: int, chunk: int, itr: int) -> Op:
    return Op(READ, worker, chunk, itr)


def w(worker: int, chunk: int, itr: int) -> Op:
    return Op(WRITE, worker, chunk, itr)


# ---------------------------------------------------------------------------
# History generators
# ---------------------------------------------------------------------------

def worker_program(worker: int, n_chunks: int, n_iters: int) -> list[list[Op]]:
    """The per-iteration op sequence each worker must issue (Def 3): read all
    partitions, then write its own.  Returns ``[ops_of_iter_1, ...]``."""
    out = []
    for a in range(1, n_iters + 1):
        ops = [r(worker, j, a) for j in range(n_chunks)]
        ops.append(w(worker, worker, a))
        out.append(ops)
    return out


def sequential_history(n_workers: int, n_iters: int) -> list[Op]:
    """The single-threaded ground-truth execution (Algorithm 1 / SEQ_1)."""
    h: list[Op] = []
    for a in range(1, n_iters + 1):
        for j in range(n_workers):
            h.append(r(0, j, a))  # single thread: worker id irrelevant
        for j in range(n_workers):
            h.append(Op(WRITE, j, j, a))
    return h


def bsp_history(n_workers: int, n_iters: int,
                read_perm: Sequence[int] | None = None,
                write_perm: Sequence[int] | None = None) -> list[Op]:
    """A canonical bulk-synchronous execution (Algorithm 2a): all reads of an
    iteration (in any order), then all writes (in any order)."""
    h: list[Op] = []
    workers = list(range(n_workers))
    for a in range(1, n_iters + 1):
        rp = list(read_perm) if read_perm is not None else workers
        wp = list(write_perm) if write_perm is not None else workers
        for i in rp:
            for j in range(n_workers):
                h.append(r(i, j, a))
        for i in wp:
            h.append(w(i, i, a))
    return h


def is_complete(h: History, n_workers: int, n_iters: int) -> bool:
    """Every worker performed its full Def-3 program exactly once."""
    need = set()
    for i in range(n_workers):
        for a in range(1, n_iters + 1):
            for j in range(n_workers):
                need.add(Op(READ, i, j, a))
            need.add(Op(WRITE, i, i, a))
    return set(h) == need and len(h) == len(need)


# ---------------------------------------------------------------------------
# Constraint predicates (Secs 4.3, 4.4, 7)
# ---------------------------------------------------------------------------

def _positions(h: History) -> dict[Op, int]:
    return {op: idx for idx, op in enumerate(h)}


def satisfies_read_constraint(h: History, delta: int = 0) -> bool:
    """RC (delta=0):  w_j[pi_j][alpha] < r_i[pi_j][alpha+1].
    Async RC (Sec 7): w_j[pi_j][alpha-1-delta] < r_i[pi_j][alpha]."""
    pos = _positions(h)
    for op in h:
        if op.kind != READ:
            continue
        want = op.itr - 1 - delta
        if want < 1:
            continue  # initial values suffice
        dep = Op(WRITE, op.chunk, op.chunk, want)
        if dep in pos and pos[dep] > pos[op]:
            return False
        # in a complete history the dependency write must exist
        if dep not in pos and any(o.kind == WRITE and o.chunk == op.chunk
                                  and o.itr == want for o in h):
            return False
    return True


def satisfies_write_constraint(h: History, n_workers: int,
                               delta: int = 0) -> bool:
    """WC (delta=0):  r_j[pi_i][alpha] < w_i[pi_i][alpha]  for every j.
    Async WC (Sec 7): r_j[pi_i][alpha-delta] < w_i[pi_i][alpha]."""
    pos = _positions(h)
    for op in h:
        if op.kind != WRITE:
            continue
        want = op.itr - delta
        if want < 1:
            continue
        for k in range(n_workers):
            dep = Op(READ, k, op.chunk, want)
            if dep in pos and pos[dep] > pos[op]:
                return False
    return True


def satisfies_read_barrier(h: History, n_workers: int) -> bool:
    """Read barrier: forall i,j,k  w_k[pi_k][alpha] < r_i[pi_j][alpha+1]."""
    pos = _positions(h)
    for op in h:
        if op.kind != READ or op.itr < 2:
            continue
        for k in range(n_workers):
            dep = Op(WRITE, k, k, op.itr - 1)
            if dep in pos and pos[dep] > pos[op]:
                return False
    return True


def satisfies_write_barrier(h: History, n_workers: int) -> bool:
    """Write barrier: forall i,j,k  r_k[pi_j][alpha] < w_i[pi_i][alpha]."""
    pos = _positions(h)
    for op in h:
        if op.kind != WRITE:
            continue
        for k in range(n_workers):
            for j in range(n_workers):
                dep = Op(READ, k, j, op.itr)
                if dep in pos and pos[dep] > pos[op]:
                    return False
    return True


def satisfies_bsp(h: History, n_workers: int) -> bool:
    return (satisfies_read_barrier(h, n_workers)
            and satisfies_write_barrier(h, n_workers))


def satisfies_rcwc(h: History, n_workers: int, delta: int = 0) -> bool:
    return (satisfies_read_constraint(h, delta)
            and satisfies_write_constraint(h, n_workers, delta))


# ---------------------------------------------------------------------------
# Definition 4 / Theorem-5 correctness conditions
# ---------------------------------------------------------------------------

def is_strictly_sequential(h: History, n_workers: int) -> bool:
    """Global Def-4 check: iterations do not interleave at all; within each
    iteration every read precedes every write; iteration numbers increase."""
    cur = 0
    phase = WRITE  # so that the first op (a read of itr 1) bumps cur
    for op in h:
        if op.itr == cur + 1:
            if phase != WRITE and cur != 0:
                return False  # previous iteration had no writes yet? malformed
            cur += 1
            phase = READ
        elif op.itr != cur:
            return False
        if op.kind == READ:
            if phase == WRITE:
                return False  # read after a write within the same iteration
        else:
            phase = WRITE
    return True


def chunk_projection(h: History, chunk: int) -> list[Op]:
    """The sub-history of ops touching one partition — the unit on which
    the Theorem-5 conditions (and a sharded backend's per-shard
    histories) are defined."""
    return [op for op in h if op.chunk == chunk]


def is_order_preserving_merge(merged: History,
                              parts: Sequence[History]) -> bool:
    """True iff every ``part`` appears as a subsequence of ``merged`` and
    ``merged`` contains exactly the ops of the parts — the invariant a
    distributed history merge must maintain (each shard's local order is
    authoritative for the chunks it owns)."""
    if len(merged) != sum(len(p) for p in parts):
        return False
    for part in parts:
        it = iter(merged)
        if not all(any(op == m for m in it) for op in part):
            return False
    return True


def is_sequentially_correct(h: History, n_workers: int) -> bool:
    """Per-partition conditions from the proof of Theorem 5:
    projecting the history onto any single partition gives (1) no
    inter-iteration interleaving, (2) reads-before-write within an iteration,
    (3) consecutive iterations.

    ``n_workers`` bounds the default chunk range; histories with more
    chunks than workers (e.g. the training engine, where one logical
    worker owns many chunks) are handled by projecting every chunk id that
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


# ---------------------------------------------------------------------------
# Semantic interpreter — execute a history, compare with sequential result
# ---------------------------------------------------------------------------

UpdateFn = Callable[[int, np.ndarray], np.ndarray]
# f(worker, full_theta) -> new value for worker's chunk


def default_update(n_workers: int, dim: int, seed: int = 0) -> UpdateFn:
    """A generic non-commuting fixed-point update: theta_i <- A_i @ theta + b_i.
    Non-symmetric A_i makes any mis-ordering numerically visible."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n_workers, dim, n_workers * dim)) * 0.1
    b = rng.normal(size=(n_workers, dim))

    def f(worker: int, theta: np.ndarray) -> np.ndarray:
        return A[worker] @ theta + b[worker]

    return f


def execute_history(h: History, n_workers: int, dim: int,
                    update: UpdateFn | None = None,
                    theta0: np.ndarray | None = None) -> np.ndarray:
    """Run the reads/writes of ``h`` against a store.  Worker-local read
    buffers accumulate the chunk values each worker saw for its current
    iteration; a write applies the update function to the buffered snapshot.
    Returns the final concatenated theta."""
    update = update or default_update(n_workers, dim)
    store = (np.zeros((n_workers, dim)) if theta0 is None
             else theta0.reshape(n_workers, dim).copy())
    # buffers[worker][itr][chunk] — a worker may legally begin reading for
    # iteration alpha+1 before issuing its own iteration-alpha write (cf. H2)
    buffers: dict[int, dict[int, dict[int, np.ndarray]]] = {
        i: {} for i in range(n_workers)}
    for op in h:
        if op.kind == READ:
            buffers[op.worker].setdefault(op.itr, {})[op.chunk] = \
                store[op.chunk].copy()
        else:
            snap_chunks = buffers[op.worker].pop(op.itr)
            snap = np.concatenate([snap_chunks[j] for j in range(n_workers)])
            store[op.chunk] = update(op.worker, snap)
    return store.reshape(-1)


def sequential_result(n_workers: int, n_iters: int, dim: int,
                      update: UpdateFn | None = None,
                      theta0: np.ndarray | None = None) -> np.ndarray:
    """Ground truth: Algorithm 1 executed single-threaded."""
    update = update or default_update(n_workers, dim)
    theta = (np.zeros(n_workers * dim) if theta0 is None else theta0.copy())
    for _ in range(n_iters):
        snap = theta.copy()
        new = [update(i, snap) for i in range(n_workers)]
        theta = np.concatenate(new)
    return theta


# ---------------------------------------------------------------------------
# Paper's example histories (Fig 3)
# ---------------------------------------------------------------------------

def paper_h1() -> list[Op]:
    return [r(1, 1, 1), r(1, 2, 1), r(2, 1, 1), r(2, 2, 1), w(1, 1, 1),
            w(2, 2, 1), r(1, 1, 2), r(1, 2, 2), r(2, 1, 2), r(2, 2, 2),
            w(1, 1, 2), w(2, 2, 2)]


def paper_h2() -> list[Op]:
    return [r(1, 1, 1), r(1, 2, 1), r(2, 1, 1), r(2, 2, 1), w(2, 2, 1),
            r(1, 2, 2), w(1, 1, 1), r(1, 1, 2), r(2, 1, 2), r(2, 2, 2),
            w(1, 1, 2), w(2, 2, 2)]


def paper_h3() -> list[Op]:
    return [r(1, 1, 1), r(1, 2, 1), w(1, 1, 1), r(2, 1, 1), r(2, 2, 1),
            w(2, 2, 1), r(1, 1, 2), r(1, 2, 2), w(1, 1, 2), r(2, 1, 2),
            r(2, 2, 2), w(2, 2, 2)]


def normalize_history(h: Iterable[Op], base: int = 1) -> list[Op]:
    """Shift worker/chunk ids to 0-based (paper figures use 1-based)."""
    return [Op(o.kind, o.worker - base, o.chunk - base, o.itr) for o in h]
