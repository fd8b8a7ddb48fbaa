"""The feed-forward, device time a step: part ``model.mlp`` in every
phase (``transformer._apply_ffn``: the MLP, the experts or the channel
mix; their backward and remat's second forward)."""
from ._spans import part_ms_per_step


def read(run):
    return part_ms_per_step(run, "model.mlp")
