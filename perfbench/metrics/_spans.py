"""Device time by the benchmark span a device operation was launched in."""
from __future__ import annotations


def span_ms_per_step(run, span: str) -> float | None:
    """Milliseconds of device time a traced step launched from inside
    ``span`` (innermost), or None when no step was traced."""
    if not run.steps:
        return None
    us = sum(op.dur_us for op in run.trace.ops if op.span == span)
    return us / 1e3 / run.steps
