"""Dispatch layer over the port's CUDA kernels and their plain versions.

The models call only these entry points.  The route follows the device of
the tensor: a CPU tensor takes the plain PyTorch version (``ref``); a CUDA
tensor launches the hand-written kernel, which raises on what it does not
take.  There is no environment switch and no fallback from one to the
other.  ``launches`` counts kernel launches per kernel (the wrappers add
one right after each launch).
"""
from __future__ import annotations

import torch

from . import ref
from ._build import launches, reset_launches
from .decode_attention import decode_attention as _decode_attention
from .flash_attention import FlashAttention
from .page_gather import page_gather as _page_gather
from .ring_gather import ring_gather as _ring_gather

__all__ = ["attention", "attention_decode", "page_gather", "ring_gather",
           "launches", "reset_launches", "CHUNK_THRESHOLD"]

# on the CPU, sequences at or above this length take the blockwise path
# (bounded score-matrix memory), as in repro.kernels.ops
CHUNK_THRESHOLD = 4096


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel route for device {t.device}")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """Differentiable on both routes: on the card through
    :class:`FlashAttention` (forward and backward kernels), on the CPU
    through autograd of the plain version."""
    if _on_cuda(q):
        return FlashAttention.apply(q, k, v, causal, window)
    S = q.shape[1]
    if S >= CHUNK_THRESHOLD and S % min(1024, S) == 0 \
            and q.shape[1] == k.shape[1]:
        return ref.attention_chunked(q, k, v, causal=causal, window=window)
    return ref.attention(q, k, v, causal=causal, window=window)


def attention_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    if _on_cuda(q):
        return _decode_attention(q, k, v, valid)
    return ref.attention_decode(q, k, v, valid)


def page_gather(pool: torch.Tensor, page_table: torch.Tensor
                ) -> torch.Tensor:
    """Paged-KV logical view: pool (P, page, ...) + page_table (B, n_pp)
    -> (B, n_pp * page, ...)."""
    if _on_cuda(pool):
        return _page_gather(pool, page_table)
    return ref.page_gather(pool, page_table)


def ring_gather(hist: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """One stacked version of a packed ring: hist (size, N) and a 0-d
    int32 device index -> hist[idx] (N,), with no host synchronisation."""
    if _on_cuda(hist):
        return _ring_gather(hist, idx)
    return ref.ring_gather(hist, idx)
