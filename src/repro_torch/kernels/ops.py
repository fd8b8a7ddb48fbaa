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
from .moe_matmul import moe_grouped_ffn as _moe_grouped_ffn
from .page_gather import page_gather as _page_gather
from .page_gather import prefill_page_attention as _prefill_page_attention
from .rglru_scan import RGLRUScan
from .ring_gather import ring_gather as _ring_gather
from .rwkv6_scan import RWKV6Scan

__all__ = ["attention", "attention_decode", "moe_grouped_ffn", "page_gather",
           "prefill_page_attention", "rglru", "ring_gather", "rwkv6",
           "rwkv6_stateful", "launches", "reset_launches", "CHUNK_THRESHOLD"]

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


def prefill_page_attention(q: torch.Tensor, k_ctx: torch.Tensor,
                           v_ctx: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, ctx_pos: torch.Tensor,
                           q_pos: torch.Tensor,
                           window: int = 0) -> torch.Tensor:
    """One prompt chunk (B, C, H, hd) against its gathered ring context
    (B, L, KV, hd) and its own keys, masked by absolute position."""
    if _on_cuda(q):
        return _prefill_page_attention(q, k_ctx, v_ctx, k_new, v_new,
                                       ctx_pos, q_pos, window=window)
    return ref.prefill_page_attention(q, k_ctx, v_ctx, k_new, v_new,
                                      ctx_pos, q_pos, window=window)


def ring_gather(hist: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """One stacked version of a packed ring: hist (size, N) and a 0-d
    int32 device index -> hist[idx] (N,), with no host synchronisation."""
    if _on_cuda(hist):
        return _ring_gather(hist, idx)
    return ref.ring_gather(hist, idx)


def moe_grouped_ffn(dispatch: torch.Tensor, combine: torch.Tensor,
                    xg: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                    wd: torch.Tensor) -> torch.Tensor:
    """Grouped-expert SwiGLU FFN over dispatched token groups
    (models/moe.py): dispatch (G, g, E, C) bool, combine (G, g, E, C) f32,
    xg (G, g, d), wg/wu (E, d, f), wd (E, f, d) -> (G, g, d).  The card's
    route has no backward."""
    if _on_cuda(xg):
        return _moe_grouped_ffn(dispatch, combine, xg, wg, wu, wd)
    return ref.moe_grouped_ffn(dispatch, combine, xg, wg, wu, wd)


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
          u: torch.Tensor) -> torch.Tensor:
    """The RWKV-6 WKV recurrence from a zero state (models/rwkv6.py): r, k,
    v (B, T, H, hd) in the compute dtype, w (B, T, H, hd) f32, u (H, hd) ->
    (B, T, H, hd) in r's dtype.  Differentiable on both routes: on the card
    through :class:`RWKV6Scan` (forward and backward kernels), on the CPU
    through autograd of the plain version."""
    if _on_cuda(r):
        return RWKV6Scan.apply(r, k, v, w, u)
    return ref.rwkv6(r, k, v, w, u)


def rwkv6_stateful(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, S0: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The recurrence from the state S0 (B, H, hd, hd) -> (y, final f32
    state).  The plain version on every device, as in the JAX package,
    where the stateful (decode) path never reaches the kernel."""
    return ref.rwkv6_stateful(r, k, v, w, u, S0)


def rglru(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The RG-LRU recurrence from a zero state (models/rglru.py): x, a
    (B, T, D) in the compute dtype -> h (B, T, D) in x's dtype.
    Differentiable on both routes: on the card through :class:`RGLRUScan`
    (forward and backward kernels), on the CPU through autograd of the
    plain version."""
    if _on_cuda(x):
        return RGLRUScan.apply(x, a)
    return ref.rglru(x, a)[0]
