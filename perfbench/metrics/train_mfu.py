"""The whole step's share of the chip's bf16 peak: model FLOPs a token
(``counts.model_flops_per_token``) times the run's tokens per second over
its whole window."""
from perfbench import counts


def read(run):
    if not run.tokens_per_s:
        return None
    flops = counts.model_flops_per_token(run.cfg, run.traffic["seq"])
    return 100.0 * flops * run.tokens_per_s / counts.PEAK_FLOPS["bfloat16"]
