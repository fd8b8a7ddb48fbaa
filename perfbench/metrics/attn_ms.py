"""Attention, device time a step: part ``model.attn`` in every phase
(``models/attention.attention_fwd``: projections, RoPE, flash, output;
their backward and remat's second forward)."""
from ._spans import part_ms_per_step


def read(run):
    return part_ms_per_step(run, "model.attn")
