"""The norms, device time a step: part ``model.norm`` in every phase
(``transformer._normed``: each block's two norms and the final one)."""
from ._spans import part_ms_per_step


def read(run):
    return part_ms_per_step(run, "model.norm")
