"""CUDA single-token decode attention (``csrc/decode_attention.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py``
(``decode_attention``, ``pallas_call`` at :102): GQA attention of one
query token per row over a ring / paged-view KV cache masked by ``valid``.
Bound on the H100: bytes (the live K and V rows, read once).  One block
per (kv head, batch row) serves the whole query group, so each K/V row is
read once whatever the GQA ratio; warps split the cache length and merge
their online-softmax states through shared memory.  Its plain version is
``ref.attention_decode``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .flash_attention import ELEM

NAME = "decode_attention"
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {"decode_attention_fwd":
              [_P] * 5 + [_I] * 6 + [_LL] * 11 + [ctypes.c_float, _P]}
HEAD_DIMS = (64, 128)
MAX_GROUP = 8


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """q: (B, 1, H, hd); k, v: (B, L, KV, hd); valid: (L,) or (B, L) bool,
    at least one live slot per row -> (B, 1, H, hd) in q's dtype."""
    if q.device.type != "cuda":
        raise ValueError(f"{NAME}: CUDA tensors only, got {q.device}")
    if not (q.device == k.device == v.device == valid.device):
        raise ValueError(f"{NAME}: inputs on different devices")
    if q.dtype not in ELEM or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"{NAME}: dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 4 or q.shape[1] != 1 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"{NAME}: shapes {q.shape} {k.shape} {v.shape}")
    B, _, H, hd = q.shape
    L, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % KV:
        raise ValueError(f"{NAME}: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if hd not in HEAD_DIMS or H // KV > MAX_GROUP:
        raise ValueError(f"{NAME}: head dim {hd} (want one of {HEAD_DIMS}) "
                         f"or group {H // KV} (max {MAX_GROUP})")
    vec = 16 // q.element_size()          # 16-byte vector loads
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.stride(-1) != 1 or t.data_ptr() % 16
                or any(s % vec for s in t.stride()[:3])):
            raise ValueError(f"{NAME}: {name} rows must be contiguous and "
                             "16-byte aligned")
    if valid.shape not in ((L,), (B, L)):
        raise ValueError(f"{NAME}: valid {tuple(valid.shape)} vs L={L}")
    live = valid.to(torch.uint8).expand(B, L).contiguous()
    o = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    lib = _build.load(NAME, SIGNATURES)
    with torch.cuda.device(q.device):
        rc = lib.decode_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), live.data_ptr(),
            o.data_ptr(), ELEM[q.dtype], B, L, H, KV, hd,
            q.stride(0), q.stride(2), *k.stride()[:3], *v.stride()[:3],
            live.stride(0), o.stride(0), o.stride(2), hd ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, NAME)
    _build.launches[NAME] += 1
    return o
