"""CUDA row gather for the ParameterDB delta ring (``csrc/ring_gather.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/ring_gather.py``
(``ring_gather``, ``pallas_call`` at :54): ``hist[idx]`` for a packed
(size, N) ring of parameter versions, bit for bit.  Bound on the H100:
bytes (the row read once and written once).  The index stays on the
device: the kernel reads it from device memory, so this wrapper never asks
the host for its value and never synchronises.  Offsets are 64-bit (a
full-width llama3.2-1b row has ~1.24e9 f32 elements).  Its plain version
is ``ref.ring_gather``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

NAME = "ring_gather"
_P = ctypes.c_void_p
SIGNATURES = {"ring_gather_fwd":
              [_P, _P, _P, ctypes.c_int, ctypes.c_longlong, _P]}


def ring_gather(hist: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """hist: (size, N) contiguous CUDA tensor; idx: 0-d int32 tensor on the
    same device, in [0, size) -> hist[idx] (N,) in hist's dtype."""
    if hist.device.type != "cuda" or idx.device != hist.device:
        raise ValueError(f"{NAME}: CUDA tensors on one device only, got "
                         f"{hist.device} / {idx.device}")
    if idx.dtype != torch.int32 or idx.ndim != 0:
        raise ValueError(f"{NAME}: idx must be a 0-d int32 tensor, got "
                         f"{idx.dtype} of shape {tuple(idx.shape)}")
    if hist.ndim != 2 or not hist.is_contiguous():
        raise ValueError(f"{NAME}: hist must be a contiguous (size, N)")
    size, n = hist.shape
    out = torch.empty((n,), dtype=hist.dtype, device=hist.device)
    row_bytes = n * hist.element_size()
    if row_bytes == 0:
        return out
    if row_bytes % 2:
        raise ValueError(f"{NAME}: rows of {row_bytes} bytes; need an even "
                         "byte length")
    lib = _build.load(NAME, SIGNATURES)
    with torch.cuda.device(hist.device):
        rc = lib.ring_gather_fwd(
            hist.data_ptr(), idx.data_ptr(), out.data_ptr(), size, row_bytes,
            torch.cuda.current_stream(hist.device).cuda_stream)
    _build.check(lib, rc, NAME)
    _build.count(NAME)
    return out
