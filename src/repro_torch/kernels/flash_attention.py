"""CUDA flash attention for prefill (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``, ``pallas_call`` at :114): causal / sliding-window GQA
attention with an online softmax in f32.  Bound on the H100: bytes for
short prompts, operations for long ones (4 * hd * H * B * S(S+1)/2 FLOPs
for a causal prefill, about 0.4*S per byte at llama3.2-1b's heads, so the
two meet near S = 740).  The kernel runs one block per (64-row q tile,
q head, batch row), skips tiles entirely above the diagonal or behind the
window, re-masks dead keys' probabilities, and reads the (B, S, H, hd)
layout through strides, so this wrapper makes no transposes.  Its plain
version is ``ref.attention``.

Sq == Sk only: the Pallas kernel is wrong for Sk != Sq (it masks by the
query length), and cross-attention is not on this slice's path.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

NAME = "flash_attention"
ELEM = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {"flash_attention_fwd":
              [_P] * 4 + [_I] * 6 + [_LL] * 12
              + [ctypes.c_float, _I, _I, _P]}
MAX_HD = 128


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, S, KV, hd) CUDA tensors of one dtype ->
    (B, S, H, hd)."""
    if q.device.type != "cuda":
        raise ValueError(f"{NAME}: CUDA tensors only, got {q.device}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{NAME}: q, k, v on different devices")
    if q.dtype not in ELEM or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"{NAME}: dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"{NAME}: shapes {q.shape} {k.shape} {v.shape}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % KV:
        raise ValueError(f"{NAME}: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if k.shape[1] != S:
        raise ValueError(f"{NAME}: needs Sq == Sk, got {S} and {k.shape[1]}")
    if hd > MAX_HD:
        raise ValueError(f"{NAME}: head dim {hd} > {MAX_HD}")
    if min(t.stride(-1) for t in (q, k, v)) != 1:
        raise ValueError(f"{NAME}: head dim must be contiguous")
    o = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    lib = _build.load(NAME, SIGNATURES)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            ELEM[q.dtype], B, S, H, KV, hd, *strides, hd ** -0.5,
            int(causal), int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, NAME)
    _build.launches[NAME] += 1
    return o
