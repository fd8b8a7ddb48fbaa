"""Sliding-window causal self-attention (``local``): ``mix_attn`` with each
query's keys limited to the last ``window`` positions."""
from perfbench.kinds import mix_attn
from perfbench.kinds.mix_attn import SOURCES, launches, weights  # noqa: F401


def flops(cfg: dict, seq: int) -> float:
    return mix_attn.flops(cfg, seq, cfg["window"])


def kernels(cfg: dict, tr: dict) -> dict:
    return mix_attn.kernels(cfg, tr, cfg["window"])
