"""The output head, device time a step: part ``model.head`` in every
phase (``transformer._nll``: the logits and the cross entropy)."""
from ._spans import part_ms_per_step


def read(run):
    return part_ms_per_step(run, "model.head")
