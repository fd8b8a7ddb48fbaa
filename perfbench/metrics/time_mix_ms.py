"""RWKV-6's time mix, device time a step: parts ``model.time_mix`` and
``model.wkv`` in every phase (``models/rwkv6.time_mix_fwd``: the token
shifts and LoRAs, the r, k, v, g and output products, the decay, the WKV
kernels, the group norm and gate; their backward and remat's second
forward)."""
from ._spans import part_ms_per_step

PARTS = ("model.time_mix", "model.wkv")


def read(run):
    ms = [v for p in PARTS if (v := part_ms_per_step(run, p)) is not None]
    return sum(ms) if ms else None
