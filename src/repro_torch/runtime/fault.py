"""Failure handling for the training loop (own copy of the single-process
part of ``repro.runtime.fault``; the parameter-server shard drills come
with the server backend).

``run_with_recovery`` wraps a step function with deterministic failure
injection (for tests and restart drills), non-finite-loss detection,
bounded retries, and checkpoint-resume integration: an injected failure
is a process-level crash that the driver turns into a restart from the
last checkpoint.
"""
from __future__ import annotations

import dataclasses
import logging
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
