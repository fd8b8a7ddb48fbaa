"""CUDA page-table gather for the paged serving KV cache
(``csrc/page_gather.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/page_gather.py``
(``page_gather``, ``pallas_call`` at :57): ``pool[page_table]`` with the
page axis folded into the cache axis, bit for bit.  Bound on the H100:
bytes (2x the output).  One block per (batch row, logical page) reads its
own page id and copies the page's contiguous row with 16-byte vector
accesses.  Its plain version is ``ref.page_gather``.  The chunked-prefill
attention of the Pallas module (``prefill_page_attention``) joins this
module in the slice that ports chunked prefill.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NAME = "page_gather"
_P = ctypes.c_void_p
SIGNATURES = {"page_gather_fwd":
              [_P, _P, _P, ctypes.c_longlong, ctypes.c_int,
               ctypes.c_longlong, _P]}


def page_gather(pool: torch.Tensor, page_table: torch.Tensor
                ) -> torch.Tensor:
    """pool: (P, page, ...) contiguous CUDA tensor; page_table: (B, n_pp)
    int32 ids in [0, P) -> (B, n_pp * page, ...) in pool's dtype."""
    if pool.device.type != "cuda" or page_table.device != pool.device:
        raise ValueError(f"{NAME}: CUDA tensors on one device only, got "
                         f"{pool.device} / {page_table.device}")
    if page_table.dtype != torch.int32 or page_table.ndim != 2:
        raise ValueError(f"{NAME}: page_table must be (B, n_pp) int32")
    if not pool.is_contiguous() or pool.ndim < 2:
        raise ValueError(f"{NAME}: pool must be a contiguous (P, page, ...)")
    P, page = pool.shape[0], pool.shape[1]
    B, n_pp = page_table.shape
    row_bytes = page * math.prod(pool.shape[2:]) * pool.element_size()
    if row_bytes % 16 or pool.data_ptr() % 16:
        raise ValueError(f"{NAME}: page rows of {row_bytes} bytes; need "
                         "16-byte multiples at 16-byte alignment")
    out = torch.empty((B, n_pp * page) + tuple(pool.shape[2:]),
                      dtype=pool.dtype, device=pool.device)
    if out.numel() == 0:
        return out
    table = page_table.contiguous()
    lib = _build.load(NAME, SIGNATURES)
    with torch.cuda.device(pool.device):
        rc = lib.page_gather_fwd(
            pool.data_ptr(), table.data_ptr(), out.data_ptr(), B * n_pp, P,
            row_bytes, torch.cuda.current_stream(pool.device).cuda_stream)
    _build.check(lib, rc, NAME)
    _build.launches[NAME] += 1
    return out
