"""Mixtral's sliding-window attention (``swa``): the same as ``local``."""
from perfbench.kinds.mix_local import (SOURCES, flops, kernels,  # noqa: F401
                                       launches, weights)
