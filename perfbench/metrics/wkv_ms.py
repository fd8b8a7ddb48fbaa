"""The WKV recurrence, device time a step: part ``model.wkv`` in every
phase (``kernels/ops.rwkv6``: the forward kernels, their backward and
remat's second forward)."""
from ._spans import part_ms_per_step


def read(run):
    return part_ms_per_step(run, "model.wkv")
