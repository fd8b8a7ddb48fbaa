"""CUDA WKV recurrence of RWKV-6 for training (``csrc/rwkv6_scan.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/rwkv6_scan.py``
(``rwkv6_scan``, ``pallas_call`` at :73): per (batch, head) an (hd, hd) f32
state, y_t = r_t S_t + (r_t . (u * k_t)) v_t and S_{t+1} = diag(w_t) S_t +
k_t v_t^T.  r, k, v in the compute dtype, the decay w in f32 (as the model
makes it), u (H, hd) in f32; y in r's dtype.  Any T, read through strides
in the (B, T, H, hd) layout, head dims 16 (the smoke config) and 64.
Bound on the H100: operations (5 hd^2 f32 FLOPs a step) in the ideal;
in practice the T dependent steps of each (b, h) chain, one block per
chain.  Its plain version is ``ref.rwkv6``.

Training needs the gradient, which the Pallas kernel never had (the JAX
package trains through autodiff of the ``lax.scan`` in its plain
version).  :class:`RWKV6Scan` wraps the forward, which then also writes the
state every ``chunk()`` steps, and a backward kernel (``rwkv6_scan_bwd``:
dr, dk, dv in r's dtype, dw and du in f32; each chunk's states rebuilt from
its checkpoint, never by dividing by w; deterministic, no atomics) in a
``torch.autograd.Function``; its oracle is torch autograd through
``ref.rwkv6``.  The two are counted apart in ``_build.launches``, one
launch per wrapper call (the backward's call runs the chunked walk and an
ordered f64 sum of du over the batch).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

NAME = "rwkv6_scan"
BWD_NAME = "rwkv6_scan_bwd"
ELEM = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64)
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "rwkv6_scan_ck": [],
    "rwkv6_scan_fwd": [_P] * 7 + [_I] * 5 + [_P, _P],
    "rwkv6_scan_bwd": [_P] * 13 + [_I] * 5 + [_P, _P],
}


def chunk() -> int:
    """The checkpoint interval, ``CK`` in csrc/rwkv6_scan.cu (builds and
    loads the library on first use)."""
    return _lib().rwkv6_scan_ck()


def n_checkpoints(T: int) -> int:
    return -(-T // chunk())


def _check(r, k, v, w, u, name: str) -> None:
    ts = (r, k, v, w, u)
    if r.device.type != "cuda" or any(t.device != r.device for t in ts):
        raise ValueError(f"{name}: CUDA tensors on one device only, got "
                         f"{[str(t.device) for t in ts]}")
    if r.dtype not in ELEM or not (r.dtype == k.dtype == v.dtype):
        raise ValueError(f"{name}: r, k, v dtypes {r.dtype}/{k.dtype}/"
                         f"{v.dtype}; one of {list(ELEM)}")
    if w.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError(f"{name}: w and u must be float32, got {w.dtype}/"
                         f"{u.dtype}")
    if r.ndim != 4 or not (r.shape == k.shape == v.shape == w.shape):
        raise ValueError(f"{name}: shapes {tuple(r.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)} {tuple(w.shape)}")
    B, T, H, hd = r.shape
    if u.shape != (H, hd) or not u.is_contiguous():
        raise ValueError(f"{name}: u must be a contiguous ({H}, {hd}), got "
                         f"{tuple(u.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} not in {HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (r, k, v, w)):
        raise ValueError(f"{name}: head dim must be contiguous")


def _strides(*ts: torch.Tensor) -> ctypes.Array:
    """(b, t, h) element strides of each tensor, as a C array."""
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _lib() -> ctypes.CDLL:
    return _build.load(NAME, SIGNATURES)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, with_state: bool = False):
    """r, k, v (B, T, H, hd) CUDA tensors of one dtype, w (B, T, H, hd) f32,
    u (H, hd) f32 -> y (B, T, H, hd) in r's dtype, or with ``with_state``
    the pair (y, ckpt) where ckpt (B, H, ceil(T / chunk()), hd, hd) f32
    holds the state before steps 0, chunk(), 2 chunk(), ..."""
    _check(r, k, v, w, u, NAME)
    B, T, H, hd = r.shape
    y = torch.empty((B, T, H, hd), dtype=r.dtype, device=r.device)
    ckpt = torch.empty((B, H, n_checkpoints(T), hd, hd), dtype=torch.float32,
                       device=r.device) if with_state else None
    if y.numel():
        lib = _lib()
        st = _strides(r, k, v, w, y)
        with torch.cuda.device(r.device):
            rc = lib.rwkv6_scan_fwd(
                r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), y.data_ptr(),
                None if ckpt is None else ckpt.data_ptr(), ELEM[r.dtype], B,
                T, H, hd, ctypes.addressof(st),
                torch.cuda.current_stream(r.device).cuda_stream)
        _build.check(lib, rc, NAME)
        _build.launches[NAME] += 1
    return (y, ckpt) if with_state else y


def rwkv6_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, ckpt: torch.Tensor,
                   dy: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Gradients (dr, dk, dv, dw, du) of ``rwkv6_scan`` given its inputs,
    the forward's checkpoints and the output's gradient ``dy`` (r's dtype
    and shape, head dim contiguous).  dr, dk, dv come back in r's dtype, dw
    and du in f32.  Deterministic: no atomics, each element written once."""
    _check(r, k, v, w, u, BWD_NAME)
    B, T, H, hd = r.shape
    if dy.shape != r.shape or dy.dtype != r.dtype or dy.device != r.device \
            or dy.stride(-1) != 1:
        raise ValueError(f"{BWD_NAME}: dy must match r's shape, dtype and "
                         f"device with a contiguous head dim, got "
                         f"{tuple(dy.shape)} {dy.dtype} {dy.device}")
    if ckpt.shape != (B, H, n_checkpoints(T), hd, hd) \
            or ckpt.dtype != torch.float32 or ckpt.device != r.device \
            or not ckpt.is_contiguous():
        raise ValueError(f"{BWD_NAME}: ckpt must be the forward's contiguous "
                         f"(B, H, ceil(T/{chunk()}), hd, hd) f32")
    grads = [torch.empty((B, T, H, hd), dtype=r.dtype, device=r.device)
             for _ in range(3)]
    dw = torch.empty((B, T, H, hd), dtype=torch.float32, device=r.device)
    du = torch.empty((H, hd), dtype=torch.float32, device=r.device)
    if dw.numel() == 0:
        return (*(g.zero_() for g in grads), dw, du.zero_())
    du_part = torch.empty((B, H, hd), dtype=torch.float64, device=r.device)
    lib = _lib()
    st = _strides(r, k, v, w, dy, *grads, dw)
    with torch.cuda.device(r.device):
        rc = lib.rwkv6_scan_bwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), ckpt.data_ptr(), dy.data_ptr(),
            *(g.data_ptr() for g in grads), dw.data_ptr(), du_part.data_ptr(),
            du.data_ptr(), ELEM[r.dtype], B, T, H, hd, ctypes.addressof(st),
            torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(lib, rc, BWD_NAME)
    _build.launches[BWD_NAME] += 1
    return (*grads, dw, du)


class RWKV6Scan(torch.autograd.Function):
    """Differentiable WKV recurrence on the card: the forward kernel (with
    its checkpoints when a gradient is wanted) and the backward kernel."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        if not any(ctx.needs_input_grad):
            return rwkv6_scan(r, k, v, w, u)
        y, ckpt = rwkv6_scan(r, k, v, w, u, with_state=True)
        ctx.save_for_backward(r, k, v, w, u, ckpt)
        return y

    @staticmethod
    def backward(ctx, dy):
        r, k, v, w, u, ckpt = ctx.saved_tensors
        # autograd hands dy in whatever layout the next op's backward made
        dy = dy if dy.stride(-1) == 1 else dy.contiguous()
        return rwkv6_scan_bwd(r, k, v, w, u, ckpt, dy)
