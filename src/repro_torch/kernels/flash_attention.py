"""CUDA flash attention for prefill and training
(``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``, ``pallas_call`` at :114): causal / sliding-window GQA
attention with an online softmax in f32.  Bound on the H100: bytes for
short prompts, operations for long ones (4 * hd * H * B * S(S+1)/2 FLOPs
for a causal prefill, about 0.4*S per byte at llama3.2-1b's heads, so the
two meet near S = 740).  The kernels skip tiles entirely above the
diagonal or behind the window, re-mask dead keys' probabilities, and read
the (B, S, H, hd) layout through strides, so this wrapper makes no
transposes.  Head dims up to 256 (recurrentgemma: 10 q heads over one kv
head, a 2048 window).  Its plain version is ``ref.attention``.

Two element types, two designs (the ``.cu``'s note): f32 runs on the CUDA
cores; bf16 on the tensor cores (the forward on ``wgmma``, the backward on
``mma.sync``), with bf16 tiles in shared memory filled by 16-byte
``cp.async``.  So a bf16 call needs q, k, v (and o, dO) with 16-byte
aligned base pointers and (b, s, h) strides, and a head dim that is a
multiple of 8; anything else raises ``ValueError``.  :func:`plan` states
the tiles, grids, shared memory and the backward's split.

Training needs the gradient, which the Pallas kernel never had (the JAX
package trains through autodiff of its plain attention).
:class:`FlashAttention` wraps the forward, which then also writes the rows'
log-sum-exp, and a backward kernel (``flash_attention_bwd``: dQ, dK, dV,
the GQA group reduced into dK/dV without atomics, deterministic) in a
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
        [_P] * 12 + [_I] * 7 + [_P, ctypes.c_float, _I, _I, _P],
    "flash_attention_smem": [_I, _I, _I],
}
MAX_HD = 256
SMEM_LIMIT = 232_448        # shared memory a block may opt into on sm_90
SMS = 132                   # H100 SXM streaming multiprocessors
TC_ROWS = 64                # bf16: q rows a forward block; backward tiles


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(S: int, H: int, KV: int, hd: int, dtype: torch.dtype) -> dict:
    """The kernels' tiles for one shape, a pure function of (S, H, KV, hd,
    dtype), never of B: a row's result does not depend on the batch.

    Returns the padded head dim ``hd_tile``; for each tiled kernel
    (``fwd``, ``dkdv``, ``dq``) its ``rows`` x ``cols`` tile (q rows by
    keys, or keys by q rows for ``dkdv``), ``threads``, shared-memory
    ``smem`` bytes and ``grid`` per batch row (the launch's grid is
    ``(*grid, B)``); and the backward's ``heads_per_block`` (q heads of one
    kv head's group that a dK/dV block walks) and ``split`` (partial dK/dV
    per kv head, summed in a fixed order after; f32 reduces the group
    inside the block, split 1).  ``csrc/flash_attention.cu``'s
    ``flash_attention_smem`` computes the same bytes (``kernel_smem``)."""
    group = H // KV
    t = 64 if hd <= 64 else 128 if hd <= 128 else 256
    if dtype == torch.bfloat16:
        keys = 32 if t > 128 else 64
        n = _cdiv(S, TC_ROWS)
        # q heads per dK/dV block: the largest divisor of the group that
        # still leaves two waves of blocks per batch row, else one
        hpb = next((d for d in range(group, 0, -1) if group % d == 0
                    and n * KV * (group // d) >= 2 * SMS), 1)
        return dict(
            hd_tile=t, heads_per_block=hpb, split=group // hpb,
            fwd=dict(rows=TC_ROWS, cols=keys, threads=128, grid=(n, H),
                     smem=1024 + t * 128 + 2 * 2 * keys * t * 2),
            dkdv=dict(rows=TC_ROWS, cols=TC_ROWS, threads=256,
                      grid=(n, KV * (group // hpb)),
                      smem=1024 + 2 * t * 128
                      + 2 * (2 * t * 128 + 2 * TC_ROWS * 4)
                      + 2 * TC_ROWS * TC_ROWS * 2),
            dq=dict(rows=TC_ROWS, cols=TC_ROWS, threads=256, grid=(n, H),
                    smem=1024 + 2 * t * 128 + 2 * 2 * t * 128
                    + TC_ROWS * TC_ROWS * 2))
    r = 32 if t > 128 else 64           # the backward's accumulating rows
    f = 4                               # f32 bytes
    return dict(
        hd_tile=t, heads_per_block=group, split=1,
        fwd=dict(rows=64, cols=64, threads=256, grid=(_cdiv(S, 64), H),
                 smem=f * (64 * (t + 1) + 64 * (t + 1) + 64 * t
                           + 64 * 65)),
        dkdv=dict(rows=r, cols=64, threads=256, grid=(_cdiv(S, r), KV),
                  smem=f * (2 * r * (t + 1) + 2 * 64 * (t + 1)
                            + 2 * r * 65 + 2 * 64)),
        dq=dict(rows=r, cols=64, threads=256, grid=(_cdiv(S, r), H),
                smem=f * (2 * r * (t + 1) + 2 * 64 * (t + 1) + r * 65
                          + 2 * r)))


def kernel_smem(dtype: torch.dtype, hd: int) -> dict[str, int]:
    """Shared-memory bytes of the built kernels at ``hd``, as the CUDA
    source computes them: {"fwd", "dkdv", "dq"}, to hold ``plan`` to."""
    lib = _build.load(NAME, SIGNATURES)
    return {kind: lib.flash_attention_smem(ELEM[dtype], hd, i)
            for i, kind in enumerate(("fwd", "dkdv", "dq"))}


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
    if q.dtype == torch.bfloat16:
        _check_aligned(name, q=q, k=k, v=v)


def _check_aligned(name: str, **ts: torch.Tensor) -> None:
    """bf16 tiles are copied 16 bytes at a time: base pointers, (b, s, h)
    strides and the head dim must be multiples of 8 elements."""
    for key, t in ts.items():
        if t.shape[-1] % 8 or t.data_ptr() % 16 \
                or any(st % 8 for st in t.stride()[:3]):
            raise ValueError(
                f"{name}: bf16 {key} must have a 16-byte aligned base, "
                f"(b, s, h) strides and head dim that are multiples of 8; "
                f"got strides {t.stride()}, head dim {t.shape[-1]}, "
                f"address {t.data_ptr()}")


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
    Deterministic: no atomics, each element written once.  bf16 sums the
    group's partial dK/dV from f32 scratch (``plan``'s split)."""
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
    hpb, dkp, dvp = 0, None, None
    if q.dtype == torch.bfloat16:
        _check_aligned(BWD_NAME, o=o, do=do)
        p = plan(S, H, KV, hd, q.dtype)
        hpb = p["heads_per_block"]
        dkp, dvp = (torch.empty((B, S, KV * p["split"], hd),
                                dtype=torch.float32, device=q.device)
                    for _ in range(2))
    lib = _build.load(NAME, SIGNATURES)
    st = _strides(q, k, v, o, do, dq, dk, dv)
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), D.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            None if dkp is None else dkp.data_ptr(),
            None if dvp is None else dvp.data_ptr(), ELEM[q.dtype], B, S,
            H, KV, hd, hpb, ctypes.addressof(st), hd ** -0.5, int(causal),
            int(window), torch.cuda.current_stream(q.device).cuda_stream)
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
