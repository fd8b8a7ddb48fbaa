"""Device time a traced step: by the benchmark span a device operation was
launched in, or by the program's part or phase it was given
(``devtrace.DeviceOp``)."""
from __future__ import annotations


def span_ms_per_step(run, span: str) -> float | None:
    """Milliseconds of device time a traced step launched from inside
    ``span`` (innermost), or None when no step was traced."""
    if not run.steps:
        return None
    us = sum(op.dur_us for op in run.trace.ops if op.span == span)
    return us / 1e3 / run.steps


def _ms_where(run, keep) -> float | None:
    us = [op.dur_us for op in run.trace.ops if keep(op)]
    if not run.steps or not us:
        return None
    return sum(us) / 1e3 / run.steps


def part_ms_per_step(run, part: str) -> float | None:
    """Milliseconds of device time a traced step of the program's part
    ``part`` (a span name of ``trace.py``), every phase; None where no
    operation was given that part."""
    return _ms_where(run, lambda op: op.part == part)


def phase_ms_per_step(run, phase: str) -> float | None:
    """Milliseconds of device time a traced step in ``phase`` (forward,
    backward or recompute), every part; None where no operation ran in
    it."""
    return _ms_where(run, lambda op: op.phase == phase)
