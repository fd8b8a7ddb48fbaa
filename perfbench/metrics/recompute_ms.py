"""Remat's second forward, device time a step: phase ``recompute``,
every part (program spans opened inside a backward range)."""
from ._spans import phase_ms_per_step


def read(run):
    return phase_ms_per_step(run, "recompute")
