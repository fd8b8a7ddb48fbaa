"""CUDA flash attention for prefill and training
(``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``, ``pallas_call`` at :114): causal / sliding-window GQA
attention with an online softmax in f32.  Bound on the H100: bytes for
short prompts, operations for long ones (4 * hd * H * B * S(S+1)/2 FLOPs
for a causal prefill, about 0.4*S per byte at llama3.2-1b's heads, so the
two meet near S = 740).  The kernel runs one block per (64-row q tile,
q head, batch row), skips tiles entirely above the diagonal or behind the
window, re-masks dead keys' probabilities, and reads the (B, S, H, hd)
layout through strides, so this wrapper makes no transposes.  Head dims
up to 256 (recurrentgemma: 10 q heads over one kv head, a 2048 window);
at 256 the backward's accumulating tiles are 32 rows, to fit shared
memory.  Its plain version is ``ref.attention``.

Training needs the gradient, which the Pallas kernel never had (the JAX
package trains through autodiff of its plain attention).
:class:`FlashAttention` wraps the forward, which then also writes the rows'
log-sum-exp, and a backward kernel (``flash_attention_bwd``: dQ, dK, dV,
the GQA group reduced into dK/dV inside the kernel, deterministic) in a
``torch.autograd.Function``; its oracle is torch autograd through
``ref.attention``.  The two are counted apart in ``_build.launches``.

Sq == Sk only: the Pallas kernel is wrong for Sk != Sq (it masks by the
query length), and cross-attention is not on the ported paths.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

NAME = "flash_attention"
BWD_NAME = "flash_attention_bwd"
ELEM = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "flash_attention_fwd":
        [_P] * 5 + [_I] * 6 + [_P, ctypes.c_float, _I, _I, _P],
    "flash_attention_bwd":
        [_P] * 10 + [_I] * 6 + [_P, ctypes.c_float, _I, _I, _P],
}
MAX_HD = 256


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           name: str) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name}: CUDA tensors only, got {q.device}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: q, k, v on different devices")
    if q.dtype not in ELEM or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: shapes {q.shape} {k.shape} {v.shape}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % KV:
        raise ValueError(f"{name}: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if k.shape[1] != S:
        raise ValueError(f"{name}: needs Sq == Sk, got {S} and {k.shape[1]}")
    if hd > MAX_HD:
        raise ValueError(f"{name}: head dim {hd} > {MAX_HD}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: head dim must be contiguous")


def _strides(*ts: torch.Tensor) -> ctypes.Array:
    """(b, s, h) element strides of each tensor, as a C array."""
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    with_lse: bool = False):
    """q: (B, S, H, hd); k, v: (B, S, KV, hd) CUDA tensors of one dtype ->
    (B, S, H, hd), or with ``with_lse`` the pair (out, lse) where lse
    (B, H, S) f32 is each row's log-sum-exp of its scaled scores."""
    _check(q, k, v, NAME)
    B, S, H, hd = q.shape
    KV = k.shape[2]
    o = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if o.numel():
        lib = _build.load(NAME, SIGNATURES)
        st = _strides(q, k, v, o)
        with torch.cuda.device(q.device):
            rc = lib.flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                None if lse is None else lse.data_ptr(), ELEM[q.dtype], B,
                S, H, KV, hd, ctypes.addressof(st), hd ** -0.5, int(causal),
                int(window), torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(lib, rc, NAME)
        _build.launches[NAME] += 1
    return (o, lse) if with_lse else o


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        causal: bool = True, window: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of ``flash_attention`` given its inputs, its
    output ``o``, the output's gradient ``do`` and the forward's ``lse``.
    Deterministic: no atomics, each element written once."""
    _check(q, k, v, BWD_NAME)
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"{BWD_NAME}: o {tuple(o.shape)} / do "
                         f"{tuple(do.shape)} vs q {tuple(q.shape)}")
    if o.dtype != q.dtype or do.dtype != q.dtype or o.device != q.device \
            or do.device != q.device:
        raise ValueError(f"{BWD_NAME}: o / do must match q's dtype and "
                         "device")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 \
            or lse.device != q.device:
        raise ValueError(f"{BWD_NAME}: lse must be (B, H, S) f32 on "
                         f"{q.device}")
    o = o if o.stride(-1) == 1 else o.contiguous()
    do = do if do.stride(-1) == 1 else do.contiguous()
    lse = lse.contiguous()
    dq = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, S, KV, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, S, KV, hd), dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    D = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib = _build.load(NAME, SIGNATURES)
    st = _strides(q, k, v, o, do, dq, dk, dv)
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), D.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), ELEM[q.dtype], B, S, H, KV, hd,
            ctypes.addressof(st), hd ** -0.5, int(causal), int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, BWD_NAME)
    _build.launches[BWD_NAME] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention on the card: the forward kernel (with
    its log-sum-exp when a gradient is wanted) and the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        ctx.causal, ctx.window = causal, window
        if not any(ctx.needs_input_grad[:3]):
            return flash_attention(q, k, v, causal=causal, window=window)
        o, lse = flash_attention(q, k, v, causal=causal, window=window,
                                 with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse,
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None
