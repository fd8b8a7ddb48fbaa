"""CUDA grouped MoE FFN (``csrc/moe_grouped_ffn.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/moe_matmul.py``
(``moe_grouped_ffn``, ``pallas_call`` at :77): per (token group, expert)
``xin = dispatchᵀ x``, ``y = (silu(xin wg) * (xin wu)) wd`` and
``out = sum_e combine_e y_e``, every product accumulated in f32 and the
output rounded once to x's dtype.  Bound on the H100: bytes at the serving
shapes (each expert with a token reads its three weight matrices once).
Four launches: dispatch (slot rows and liveness read from the bool
``dispatch`` on the device), the gated up product, the down product
(split over f when its tiles alone would leave SMs idle, as at decode)
and the combine; no atomics, no host synchronisation, and experts or
slots without a token are never loaded or computed.  The wrapper
allocates the f32 scratch.  Its plain version is ``ref.moe_grouped_ffn``.

No backward: MoE training, which needs one, is a later slice of the port.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .flash_attention import ELEM

NAME = "moe_grouped_ffn"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"moe_grouped_ffn_fwd": [_P] * 11 + [_I] * 10 + [_P]}
DK = 32                 # depth of one chunk of the products
COLS = 128              # output columns per block of the products
WARPS = 8               # warps per block of the products
MAX_GRID = 65535


def slots_per_warp(C: int) -> int:
    """Slot rows per warp of the two products: WARPS x this many slots
    make a block's slot tile (8, 32 or 64 slots)."""
    return 1 if C <= 8 else 4 if C <= 32 else 8


def down_splits(G: int, E: int, C: int, d: int, f: int,
                n_sm: int) -> tuple[int, int]:
    """(splits, chunks per split) of f in the down product: enough blocks
    for about four per SM, from the shapes alone (so a token's bits never
    depend on the data), at most 8 splits."""
    cols, rows = -(-d // COLS), -(-C // (WARPS * slots_per_warp(C)))
    blocks = cols * rows * G * E
    chunks = -(-f // DK)
    ks = min(8, chunks, max(1, -(-4 * n_sm // blocks)))
    per = -(-chunks // ks)
    return -(-chunks // per), per


def moe_grouped_ffn(dispatch: torch.Tensor, combine: torch.Tensor,
                    xg: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                    wd: torch.Tensor) -> torch.Tensor:
    """dispatch: (G, g, E, C) bool; combine: (G, g, E, C) f32; xg: (G, g, d);
    wg/wu: (E, d, f); wd: (E, f, d), all CUDA tensors on one device, xg and
    the weights of one dtype (f32 or bf16), all contiguous at 16-byte
    aligned addresses, d and f multiples of 8 -> (G, g, d) in xg's
    dtype."""
    ts = (dispatch, combine, xg, wg, wu, wd)
    if xg.device.type != "cuda" or any(t.device != xg.device for t in ts):
        raise ValueError(f"{NAME}: CUDA tensors on one device only, got "
                         f"{sorted({str(t.device) for t in ts})}")
    if any(t.requires_grad for t in ts) and torch.is_grad_enabled():
        raise NotImplementedError(
            f"{NAME}: the CUDA kernel has no backward; MoE training comes "
            "with a later slice of the port")
    if dispatch.dtype != torch.bool or combine.dtype != torch.float32:
        raise ValueError(f"{NAME}: dispatch must be bool and combine f32, "
                         f"got {dispatch.dtype} / {combine.dtype}")
    if xg.dtype not in ELEM or any(w.dtype != xg.dtype for w in ts[3:]):
        raise ValueError(f"{NAME}: dtypes {[str(t.dtype) for t in ts[2:]]}")
    if dispatch.ndim != 4 or xg.ndim != 3:
        raise ValueError(f"{NAME}: dispatch (G, g, E, C) and xg (G, g, d)")
    G, g, E, C = dispatch.shape
    d = xg.shape[-1]
    f = wg.shape[-1]
    if (combine.shape != dispatch.shape or xg.shape != (G, g, d)
            or wg.shape != (E, d, f) or wu.shape != (E, d, f)
            or wd.shape != (E, f, d)):
        raise ValueError(f"{NAME}: shapes {[tuple(t.shape) for t in ts]}")
    if d % 8 or f % 8:
        raise ValueError(f"{NAME}: d {d} and f {f} must be multiples of 8")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{NAME}: inputs must be contiguous and 16-byte "
                         "aligned")
    if max(G, E) > MAX_GRID:
        raise ValueError(f"{NAME}: {G} groups or {E} experts exceed the "
                         f"grid limit {MAX_GRID}")
    out = torch.empty((G, g, d), dtype=xg.dtype, device=xg.device)
    if out.numel() == 0:
        return out
    if C == 0:
        return out.zero_()
    rm = slots_per_warp(C)
    ks, per = down_splits(G, E, C, d, f, torch.cuda.get_device_properties(
        xg.device).multi_processor_count)
    if G * E * ks > MAX_GRID:
        raise ValueError(f"{NAME}: {G} x {E} x {ks} exceeds the grid limit")
    f32 = dict(dtype=torch.float32, device=xg.device)
    xin = torch.empty((G, E, C, d), **f32)
    h = torch.empty((G, E, C, f), **f32)
    y = torch.empty((ks, G, E, C, d), **f32)
    live = torch.empty((G, E, C), dtype=torch.int32, device=xg.device)
    lib = _build.load(NAME, SIGNATURES)
    with torch.cuda.device(xg.device):
        rc = lib.moe_grouped_ffn_fwd(
            dispatch.data_ptr(), combine.data_ptr(), xg.data_ptr(),
            wg.data_ptr(), wu.data_ptr(), wd.data_ptr(), out.data_ptr(),
            xin.data_ptr(), h.data_ptr(), y.data_ptr(), live.data_ptr(),
            ELEM[xg.dtype], G, g, E, C, d, f, rm, ks, per,
            torch.cuda.current_stream(xg.device).cuda_stream)
    _build.check(lib, rc, NAME)
    _build.launches[NAME] += 1
    return out
