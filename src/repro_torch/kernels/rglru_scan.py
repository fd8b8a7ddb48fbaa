"""CUDA RG-LRU recurrence of recurrentgemma for training
(``csrc/rglru_scan.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/rglru_scan.py``
(``rglru_scan``, ``pallas_call`` at :60): elementwise over the channels,
h_t = a_t h_{t-1} + sqrt(clip(1 - a_t^2, 0, 1)) x_t with the state in f32
from zero.  x and a (B, T, D) in the compute dtype (f32 or bf16), h in x's
dtype; any T and D, read through (b, t) strides with the channel dim
contiguous.  Bound on the H100: bytes (~1 FLOP per byte).  One thread per
(b, channel) chain, its inputs loaded 16 steps ahead.  Its plain version
is ``ref.rglru``.

Training needs the gradient, which the Pallas kernel never had (the JAX
package trains through autodiff of the ``lax.scan`` in its plain
version).  :class:`RGLRUScan` wraps the forward, which then also writes
every f32 state h_t, and a backward kernel (``rglru_scan_bwd``: dx and da
in x's dtype, h_{t-1} read from the states, never recovered by dividing by
a; where 1 - a^2 <= 0 the clip is saturated and da = dh h_{t-1}, where
autodiff of the plain version gives -inf; deterministic) in a
``torch.autograd.Function``.  Its oracle is torch autograd through
``ref.rglru`` where a < 1.  The two are counted apart in
``_build.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

NAME = "rglru_scan"
BWD_NAME = "rglru_scan_bwd"
ELEM = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "rglru_scan_fwd": [_P] * 4 + [_I] * 4 + [_P, _P],
    "rglru_scan_bwd": [_P] * 6 + [_I] * 4 + [_P, _P],
}


def _check(x: torch.Tensor, a: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda" or a.device != x.device:
        raise ValueError(f"{name}: CUDA tensors on one device only, got "
                         f"{x.device} and {a.device}")
    if x.dtype not in ELEM or a.dtype != x.dtype:
        raise ValueError(f"{name}: x and a dtypes {x.dtype}/{a.dtype}; one "
                         f"of {list(ELEM)}")
    if x.ndim != 3 or a.shape != x.shape:
        raise ValueError(f"{name}: shapes {tuple(x.shape)} {tuple(a.shape)}; "
                         "both (B, T, D)")
    if x.stride(-1) != 1 or a.stride(-1) != 1:
        raise ValueError(f"{name}: the channel dim must be contiguous")


def _strides(*ts: torch.Tensor) -> ctypes.Array:
    """(b, t) element strides of each tensor, as a C array."""
    vals = [s for t in ts for s in t.stride()[:2]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _lib() -> ctypes.CDLL:
    return _build.load(NAME, SIGNATURES)


def rglru_scan(x: torch.Tensor, a: torch.Tensor, with_state: bool = False):
    """x, a (B, T, D) CUDA tensors of one dtype -> h (B, T, D) in x's dtype,
    or with ``with_state`` the pair (h, hs) where hs (B, T, D) f32 holds
    every state h_t."""
    _check(x, a, NAME)
    B, T, D = x.shape
    y = torch.empty((B, T, D), dtype=x.dtype, device=x.device)
    hs = torch.empty((B, T, D), dtype=torch.float32, device=x.device) \
        if with_state else None
    if y.numel():
        lib = _lib()
        st = _strides(x, a)
        with torch.cuda.device(x.device):
            rc = lib.rglru_scan_fwd(
                x.data_ptr(), a.data_ptr(), y.data_ptr(),
                None if hs is None else hs.data_ptr(), ELEM[x.dtype], B, T,
                D, ctypes.addressof(st),
                torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(lib, rc, NAME)
        _build.launches[NAME] += 1
    return (y, hs) if with_state else y


def rglru_scan_bwd(x: torch.Tensor, a: torch.Tensor, hs: torch.Tensor,
                   dy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Gradients (dx, da) of ``rglru_scan`` given its inputs, the forward's
    f32 states ``hs`` and the output's gradient ``dy`` (x's dtype and
    shape, channel dim contiguous), in x's dtype.  Deterministic: no
    atomics, each element written once."""
    _check(x, a, BWD_NAME)
    B, T, D = x.shape
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or dy.stride(-1) != 1:
        raise ValueError(f"{BWD_NAME}: dy must match x's shape, dtype and "
                         f"device with a contiguous channel dim, got "
                         f"{tuple(dy.shape)} {dy.dtype} {dy.device}")
    if hs.shape != x.shape or hs.dtype != torch.float32 \
            or hs.device != x.device or not hs.is_contiguous():
        raise ValueError(f"{BWD_NAME}: hs must be the forward's contiguous "
                         "(B, T, D) f32 states")
    dx = torch.empty((B, T, D), dtype=x.dtype, device=x.device)
    da = torch.empty((B, T, D), dtype=x.dtype, device=x.device)
    if dx.numel() == 0:
        return dx, da
    lib = _lib()
    st = _strides(x, a, dy)
    with torch.cuda.device(x.device):
        rc = lib.rglru_scan_bwd(
            x.data_ptr(), a.data_ptr(), hs.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), da.data_ptr(), ELEM[x.dtype], B, T, D,
            ctypes.addressof(st),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, BWD_NAME)
    _build.launches[BWD_NAME] += 1
    return dx, da


class RGLRUScan(torch.autograd.Function):
    """Differentiable RG-LRU recurrence on the card: the forward kernel
    (with its f32 states when a gradient is wanted) and the backward
    kernel."""

    @staticmethod
    def forward(ctx, x, a):
        if not any(ctx.needs_input_grad):
            return rglru_scan(x, a)
        y, hs = rglru_scan(x, a, with_state=True)
        ctx.save_for_backward(x, a, hs)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, a, hs = ctx.saved_tensors
        # autograd hands dy in whatever layout the next op's backward made
        dy = dy if dy.stride(-1) == 1 else dy.contiguous()
        return rglru_scan_bwd(x, a, hs, dy)
