"""The ParameterDB: one consistency layer, two host-driven stores (port of
``repro.pdb.db``).

A :class:`ParameterDB` holds the chunked parameter vector as torch tensors
on one device and admits ``read(worker, chunk, itr)`` /
``write(worker, chunk, itr, value)`` under a pluggable consistency
:mod:`policy <repro_torch.pdb.policies>`.  The *only* difference between
the stores is what happens when an operation is not yet admissible:

  * :class:`InProcessParameterDB` raises :class:`InadmissibleOp` — callers
    (the interleaved replay loop below, conformance tests) choose their
    own op order and must only issue admissible ops;
  * :class:`ThreadedParameterDB` blocks the calling thread on one shared
    condition variable until the policy admits the op.

Both record the identical Op history and staleness telemetry through
:class:`repro_torch.pdb.telemetry.Telemetry`, so
``repro_torch.core.history.is_sequentially_correct`` applies to both.

On the card every op runs on torch's default stream, whatever thread
issues it: a read's ``clone`` is enqueued under the store's lock, so it is
ordered before any later write's reuse of the memory it reads (the caching
allocator is stream-ordered), and a write never changes a tensor in place
— it replaces the chunk.
"""
from __future__ import annotations

import threading
from typing import Callable, Sequence

import torch

from .policies import Policy, make_policy
from .telemetry import Telemetry


class InadmissibleOp(RuntimeError):
    """A non-blocking backend was asked to execute an op its policy rejects."""


class WaitTimeout(RuntimeError):
    """A blocking backend gave up waiting for an op to become admissible.

    Carries the stalled op's coordinates so callers and tests can tell
    *which* operation deadlocked, not just that something did."""

    def __init__(self, kind: str, worker: int, chunk: int, itr: int,
                 timeout: float | None, policy: Policy, where: str = "",
                 message: str | None = None):
        self.kind, self.worker, self.chunk, self.itr = kind, worker, chunk, itr
        self.timeout = timeout
        super().__init__(message if message is not None else
                         stall_diagnostic(kind, worker, chunk, itr,
                                          timeout, policy, where))


def stall_diagnostic(kind: str, worker: int, chunk: int, itr: int,
                     timeout: float | None, policy: Policy,
                     where: str = "") -> str:
    """One formatted line naming the stalled op and the policy state that is
    blocking it."""
    op = f"{kind}{worker}[pi{chunk}][{itr}]"
    state = ""
    describe = getattr(policy, "describe", None)
    if describe is not None:
        try:
            state = f"; state: {describe(worker, chunk, itr)}"
        except Exception:
            state = ""
    suffix = f" at {where}" if where else ""
    return (f"ParameterDB wait timed out after {timeout}s on {op}{suffix} "
            f"(worker={worker} chunk={chunk} itr={itr}, "
            f"policy={type(policy).__name__}{state})")


class ParameterDB:
    """Shared storage + admission + telemetry; subclasses define waiting.

    The chunks are copies of ``init_chunks`` (tensors or arrays) on
    ``device``, by default the device of the first chunk."""

    def __init__(self, init_chunks: Sequence, n_workers: int,
                 policy: Policy | str = "dc",
                 delta: float | Sequence[float] = 0,
                 record: bool = False,
                 device: str | torch.device | None = None):
        firsts = [torch.as_tensor(c) for c in init_chunks]
        self.device = torch.device(device) if device is not None \
            else firsts[0].device
        self.chunks = [c.to(self.device, copy=True) for c in firsts]
        self.p = n_workers
        self.m = len(self.chunks)
        if isinstance(policy, str):
            policy = make_policy(policy, n_workers, delta, n_chunks=self.m)
        self.policy = policy
        # last committed iteration per chunk, for staleness telemetry
        # (kept here, not in the policy: SSP has no chunk versions)
        self._version = [0] * self.m
        self.telemetry = Telemetry(record_history=record)

    # -- admission passthroughs (for callers that pick their own op order) --
    def can_read(self, worker: int, chunk: int, itr: int) -> bool:
        return self.policy.can_read(worker, chunk, itr)

    def can_write(self, worker: int, chunk: int, itr: int) -> bool:
        return self.policy.can_write(worker, chunk, itr)

    @property
    def history(self):
        return self.telemetry.history

    def read_all(self, worker: int, itr: int) -> list[torch.Tensor]:
        """The full Def-3 read set of one iteration: per-chunk reads in
        admission order."""
        return [self.read(worker, j, itr) for j in range(self.m)]

    def values(self) -> list[torch.Tensor]:
        return [c.clone() for c in self.chunks]

    def theta(self) -> torch.Tensor:
        return torch.cat(self.chunks)

    # -- the commit bodies shared by every subclass (call under exclusion) --
    def _do_read(self, worker: int, chunk: int, itr: int) -> torch.Tensor:
        val = self.chunks[chunk].clone()
        self.policy.did_read(worker, chunk, itr)
        self.telemetry.on_read(worker, chunk, itr, self._version[chunk])
        return val

    def _do_write(self, worker: int, chunk: int, itr: int,
                  value: torch.Tensor) -> None:
        self.chunks[chunk] = torch.as_tensor(value, device=self.device)
        self._version[chunk] = max(self._version[chunk], itr)
        self.policy.did_write(worker, chunk, itr)
        self.telemetry.on_write(worker, chunk, itr)


class InProcessParameterDB(ParameterDB):
    """Non-blocking backend: inadmissible ops raise."""

    def read(self, worker: int, chunk: int, itr: int) -> torch.Tensor:
        if not self.policy.can_read(worker, chunk, itr):
            raise InadmissibleOp(f"r{worker}[pi{chunk}][{itr}]")
        return self._do_read(worker, chunk, itr)

    def write(self, worker: int, chunk: int, itr: int,
              value: torch.Tensor) -> None:
        if not self.policy.can_write(worker, chunk, itr):
            raise InadmissibleOp(f"w{worker}[pi{chunk}][{itr}]")
        self._do_write(worker, chunk, itr, value)


class ThreadedParameterDB(ParameterDB):
    """Blocking backend: one condition variable, admission by the policy.

    read  blocks until policy.can_read(worker, chunk, itr)
    write blocks until policy.can_write(worker, chunk, itr)

    This subsumes both Algorithm 2a (BSP barriers) and Algorithm 2b / the
    Sec-7.1 protocol: the barrier-vs-constraint distinction lives entirely
    in the policy's admission predicates.
    """

    def __init__(self, *args, timeout: float | None = 300.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.cond = threading.Condition()
        self.timeout = timeout

    def _wait_for(self, pred: Callable[[], bool], kind: str,
                  worker: int, chunk: int, itr: int) -> None:
        if not self.cond.wait_for(pred, timeout=self.timeout):
            raise WaitTimeout(kind, worker, chunk, itr, self.timeout,
                              self.policy)

    def read(self, worker: int, chunk: int, itr: int) -> torch.Tensor:
        with self.cond:
            self._wait_for(
                lambda: self.policy.can_read(worker, chunk, itr),
                "r", worker, chunk, itr)
            val = self._do_read(worker, chunk, itr)
            self.cond.notify_all()
            return val

    def write(self, worker: int, chunk: int, itr: int,
              value: torch.Tensor) -> None:
        with self.cond:
            self._wait_for(
                lambda: self.policy.can_write(worker, chunk, itr),
                "w", worker, chunk, itr)
            self._do_write(worker, chunk, itr, value)
            self.cond.notify_all()


# ---------------------------------------------------------------------------
# Deterministic interleaved replay (in-process backend)
# ---------------------------------------------------------------------------

UpdateFn = Callable[[int, torch.Tensor, int], torch.Tensor]
# update(worker, full_theta_snapshot, itr) -> new value for worker's chunk


def run_interleaved(db: InProcessParameterDB, n_iters: int,
                    update: UpdateFn, seed: int = 0) -> torch.Tensor:
    """Drive every worker's Def-3 program (read all chunks, compute, write
    own chunk) through ``db``, choosing uniformly at random among the
    admissible next ops — a seeded single-threaded model of an arbitrary
    parallel interleaving.  The moves are listed and drawn as the JAX
    package draws them (``random.Random(seed)``), so a seed picks the same
    interleaving there and here.  Raises if the policy ever deadlocks.
    Returns the final concatenated theta."""
    import random as _random

    rng = _random.Random(seed)
    p, m = db.p, db.m
    itr = [1] * p
    unread = [set(range(m)) for _ in range(p)]
    buffers: list[dict[int, torch.Tensor]] = [{} for _ in range(p)]

    while any(a <= n_iters for a in itr):
        moves: list[tuple[str, int, int]] = []
        for i in range(p):
            if itr[i] > n_iters:
                continue
            if unread[i]:
                moves += [("r", i, j) for j in sorted(unread[i])
                          if db.can_read(i, j, itr[i])]
            elif db.can_write(i, i, itr[i]):
                moves.append(("w", i, i))
        if not moves:
            raise RuntimeError(
                f"deadlock in run_interleaved "
                f"(policy={type(db.policy).__name__})")
        kind, i, j = rng.choice(moves)
        if kind == "r":
            buffers[i][j] = db.read(i, j, itr[i])
            unread[i].discard(j)
        else:
            snap = torch.cat([buffers[i][k] for k in range(m)])
            db.write(i, i, itr[i], update(i, snap, itr[i]))
            itr[i] += 1
            unread[i] = set(range(m))
            buffers[i] = {}
    return db.theta()
