"""Failure handling for the training loop and the sharded parameter server
(own copy of ``repro.runtime.fault``).

``run_with_recovery`` wraps a step function with deterministic failure
injection (for tests and restart drills), non-finite-loss detection,
bounded retries, and checkpoint-resume integration: an injected failure
is a process-level crash that the driver turns into a restart from the
last checkpoint.  ``Backoff`` + ``retry_with_backoff`` are the client-side
half of shard-death survival: the distributed client
(:mod:`repro_torch.pdb.server.client`) routes every RPC through them, so a
killed-and-restarted shard shows up as ``retried_steps`` in the same
staleness telemetry that describes the run's synchronization behavior.
``ShardDeathPlan`` is the injection half: it kills a chosen shard process
at a chosen step (restart drills for the parameter server).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable

log = logging.getLogger("repro_torch.fault")


@dataclasses.dataclass
class RetryPolicy:
    max_retries: int = 2
    skip_nonfinite: bool = True     # skip a poisoned batch instead of dying


class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    """Deterministically kill specific steps (restart drills)."""
    fail_steps: tuple[int, ...] = ()
    fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.fail_steps and step not in self.fired:
            self.fired.add(step)
            raise InjectedFailure(f"injected failure at step {step}")


@dataclasses.dataclass(frozen=True)
class Backoff:
    """Exponential backoff schedule for reconnect/retry loops."""
    max_retries: int = 8
    base_delay: float = 0.05       # seconds before the first retry
    multiplier: float = 2.0
    max_delay: float = 2.0

    def delay(self, attempt: int) -> float:
        """Sleep before retry ``attempt`` (1-based), capped at max_delay."""
        return min(self.base_delay * self.multiplier ** (attempt - 1),
                   self.max_delay)


def retry_with_backoff(fn: Callable[[], Any], backoff: Backoff,
                       retry_on: tuple[type[BaseException], ...]
                       = (ConnectionError, OSError),
                       telemetry: Any | None = None,
                       describe: str = "",
                       on_retry: Callable[[int], None] | None = None) -> Any:
    """Run ``fn`` retrying on transient (connection-shaped) failures with
    exponential backoff.  Each retry is reported into ``telemetry`` (a
    :class:`repro_torch.pdb.telemetry.Telemetry`) so shard reconnects
    surface in the run's staleness summary as ``retried_steps``.  Re-raises
    the last error once the budget is exhausted.

    ``on_retry(attempt)`` runs before each backoff sleep — the hook where a
    caller resets per-attempt state.  The batched RPC client uses it to
    drop the failed shard's connection (discarding any acknowledgements
    still pipelined on the dead socket) so the replayed *batch* starts on a
    frame-aligned stream; replayed sub-ops are deduplicated shard-side, so
    a batch retry is at-least-once delivery with exactly-once recording
    per sub-op."""
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            attempt += 1
            if attempt > backoff.max_retries:
                raise
            if telemetry is not None:
                telemetry.on_retry(attempt)
            if on_retry is not None:
                on_retry(attempt)
            d = backoff.delay(attempt)
            log.warning("%s failed (%s); retry %d/%d in %.2fs",
                        describe or "op", e, attempt, backoff.max_retries, d)
            time.sleep(d)


@dataclasses.dataclass
class ShardDeathPlan:
    """Deterministically kill one parameter-server shard at a given step
    (the distributed analogue of :class:`FailureInjector`).  ``cluster`` is
    a :class:`repro_torch.pdb.server.cluster.ShardCluster`; with
    ``restart`` the shard is immediately relaunched from its snapshot, so
    clients survive via retry_with_backoff."""
    kill_at_step: int
    shard: int = 0
    restart: bool = True
    fired: bool = False

    def maybe_kill(self, step: int, cluster: Any) -> bool:
        if self.fired or step != self.kill_at_step:
            return False
        self.fired = True
        log.warning("injecting shard %d death at step %d", self.shard, step)
        cluster.kill_shard(self.shard)
        if self.restart:
            cluster.restart_shard(self.shard)
        return True


def run_with_recovery(step_fn: Callable[[Any, Any], tuple[Any, dict]],
                      state: Any, batch: Any, step: int,
                      policy: RetryPolicy,
                      injector: FailureInjector | None = None,
                      is_finite: Callable[[dict], bool] | None = None,
                      telemetry: Any | None = None
                      ) -> tuple[Any, dict, str]:
    """Execute one training step with recovery.  Returns
    (state, metrics, outcome) where outcome is 'ok' | 'retried' | 'skipped'.
    On non-finite loss the state update is discarded (the prior state is
    returned) — the safe default for poisoned batches.

    ``telemetry`` is an optional :class:`repro_torch.pdb.telemetry.Telemetry`;
    retried and skipped steps are reported into it so one object summarizes
    a run's synchronization *and* fault behavior."""
    attempts = 0
    while True:
        try:
            if injector is not None:
                injector.check(step)
            new_state, metrics = step_fn(state, batch)
            if is_finite is not None and not is_finite(metrics):
                if policy.skip_nonfinite:
                    log.warning("non-finite metrics at step %d; skipping", step)
                    if telemetry is not None:
                        telemetry.on_skip(step)
                    return state, metrics, "skipped"
                raise FloatingPointError(f"non-finite loss at step {step}")
            return new_state, metrics, ("ok" if attempts == 0 else "retried")
        except InjectedFailure:
            raise                      # process-level: handled by restart
        except FloatingPointError:
            raise
        except Exception:              # transient compute failure: retry
            attempts += 1
            if attempts > policy.max_retries:
                raise
            if telemetry is not None:
                telemetry.on_retry(step)
            log.warning("step %d failed (attempt %d); retrying", step, attempts)
