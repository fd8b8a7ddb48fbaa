"""CUDA RG-LRU recurrence of recurrentgemma for training
(``csrc/rglru_scan.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/rglru_scan.py``
(``rglru_scan``, ``pallas_call`` at :60): elementwise over the channels,
h_t = a_t h_{t-1} + sqrt(clip(1 - a_t^2, 0, 1)) x_t with the state in f32
from zero.  x and a (B, T, D) in the compute dtype (f32 or bf16), h in x's
dtype; any T and D, read through (b, t) strides with the channel dim
contiguous.  Bound on the H100: bytes (~1 FLOP per byte).  Its plain
version is ``ref.rglru``.

Chunk-parallel: a chunk of ``CHUNK`` steps acts on the state as
h -> P h + H (P the product of its a, H its walk from zero), so each
thread walks one chunk of one 4-byte word of channels, a block folds the
pairs of the chunks before each one into its start state and walks the
chunk again.  No thread walks more than ``CHUNK`` steps in a row; nothing
is divided.  :func:`plan` gives the chunk, the block and grid, the
threads and shared memory from the shapes alone; at recurrentgemma-2b's
training shape (B4 T512 D2560 bf16) 640 blocks of 8 words x 32 chunks,
163,840 threads a pass.

Training needs the gradient, which the Pallas kernel never had (the JAX
package trains through autodiff of the ``lax.scan`` in its plain
version).  :class:`RGLRUScan` wraps the forward, which then also writes
the f32 state at the end of every chunk, and a backward kernel
(``rglru_scan_bwd``: dx and da in x's dtype, h_{t-1} rebuilt from those
checkpoints, never recovered by dividing by a; the adjoint's chunk pairs
folded the same way; where 1 - a^2 <= 0 the clip is saturated and da =
dh h_{t-1}, where autodiff of the plain version gives -inf;
deterministic) in a ``torch.autograd.Function``.  Its oracle is torch
autograd through ``ref.rglru`` where a < 1.  The two are counted apart in
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
    "rglru_scan_ck": [],
    "rglru_scan_tiles": [_I] * 4,
    "rglru_scan_fwd": [_P] * 4 + [_I] * 5 + [_P, _P],
    "rglru_scan_bwd": [_P] * 6 + [_I] * 5 + [_P, _P],
}
# csrc/rglru_scan.cu: CK, SUB, MAX_SLOTS
CHUNK = 16          # steps a thread walks; the checkpoint interval
SUB = 4             # the backward's piece of states kept in registers
MAX_SLOTS = 32      # chunks a block holds at once (a window of the sequence)
TILE_KEYS = ("smem", "threads", "slots", "lanes", "vec", "sub")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(B: int, T: int, D: int, dtype: torch.dtype) -> dict:
    """The kernels' launch numbers for one shape, from the shapes alone:
    ``chunk`` (steps a thread walks), ``nc`` chunks, ``sub`` (the backward's
    piece of rebuilt states kept in registers), ``vec`` channels a thread
    (one 4-byte word: 2 in bf16, 1 in f32), a block's ``slots`` (chunks it
    holds at once) x ``lanes`` (words of channels) = ``threads``, its
    ``channels``, ``windows`` (the block walks ceil(nc / slots) windows of
    ``slots`` chunks in order, carrying the state between them: 1 where
    T <= 512), the ``grid`` (x, y) = (channel tiles, B), ``blocks``,
    ``threads_total`` a pass, where the inputs are kept (``inputs``: the
    block stages its window's rows of x and a, and of dy in the backward,
    in shared memory), the dynamic shared memory ``smem_fwd`` /
    ``smem_bwd`` a block,
    and the f32 ``checkpoint_bytes``, B * nc * D * 4."""
    vec = 4 // dtype.itemsize
    nc = _cdiv(T, CHUNK)
    slots = min(nc, MAX_SLOTS)
    lanes = 32 if slots <= 8 else 16 if slots <= 16 else 8
    threads = lanes * slots
    grid = (_cdiv(_cdiv(D, vec), lanes), B)

    def smem(nin: int) -> int:
        return 4 * (nin * CHUNK * threads + 2 * vec * threads + 2 * vec * lanes)

    return dict(chunk=CHUNK, nc=nc, sub=SUB, vec=vec, slots=slots,
                lanes=lanes, threads=threads, channels=lanes * vec,
                windows=_cdiv(nc, slots), grid=grid, blocks=grid[0] * B,
                threads_total=grid[0] * B * threads, inputs="shared",
                smem_fwd=smem(2), smem_bwd=smem(3),
                checkpoint_bytes=4 * B * nc * D)


def chunk() -> int:
    """The checkpoint interval, ``CK`` in csrc/rglru_scan.cu."""
    return CHUNK


def n_checkpoints(T: int) -> int:
    return _cdiv(T, CHUNK)


def kernel_tiles(T: int, dtype: torch.dtype) -> dict:
    """The built library's own numbers at sequence length T, to hold
    :func:`plan` to: its chunk, and per direction (``fwd``, ``bwd``) a dict
    of ``TILE_KEYS`` (shared-memory bytes, threads, slots, lanes, channels a
    thread, the backward's piece)."""
    lib = _lib()
    return dict(chunk=lib.rglru_scan_ck(), **{
        name: {k: lib.rglru_scan_tiles(d, ELEM[dtype], T, i)
               for i, k in enumerate(TILE_KEYS)}
        for d, name in enumerate(("fwd", "bwd"))})


def resident_blocks(T: int, dtype: torch.dtype) -> tuple[int, int]:
    """Blocks of the forward and of the backward resident on one SM of the
    current card at sequence length T (the occupancy calculator's)."""
    lib = _lib()
    return tuple(lib.rglru_scan_tiles(d, ELEM[dtype], T, len(TILE_KEYS))
                 for d in (0, 1))


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
    or with ``with_state`` the pair (h, ck) where ck (B, ceil(T / chunk()),
    D) f32 holds the state at the end of each chunk (after steps
    chunk() - 1, 2 chunk() - 1, ..., T - 1)."""
    _check(x, a, NAME)
    B, T, D = x.shape
    y = torch.empty((B, T, D), dtype=x.dtype, device=x.device)
    ck = torch.empty((B, n_checkpoints(T), D), dtype=torch.float32,
                     device=x.device) if with_state else None
    if y.numel():
        lib = _lib()
        st = _strides(x, a)
        with torch.cuda.device(x.device):
            rc = lib.rglru_scan_fwd(
                x.data_ptr(), a.data_ptr(), y.data_ptr(),
                None if ck is None else ck.data_ptr(), ELEM[x.dtype], B, T,
                D, CHUNK, ctypes.addressof(st),
                torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(lib, rc, NAME)
        _build.launches[NAME] += 1
    return (y, ck) if with_state else y


def rglru_scan_bwd(x: torch.Tensor, a: torch.Tensor, ck: torch.Tensor,
                   dy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Gradients (dx, da) of ``rglru_scan`` given its inputs, the forward's
    checkpoints ``ck`` and the output's gradient ``dy`` (x's dtype and
    shape, channel dim contiguous), in x's dtype.  Deterministic: no
    atomics, each element written once."""
    _check(x, a, BWD_NAME)
    B, T, D = x.shape
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or dy.stride(-1) != 1:
        raise ValueError(f"{BWD_NAME}: dy must match x's shape, dtype and "
                         f"device with a contiguous channel dim, got "
                         f"{tuple(dy.shape)} {dy.dtype} {dy.device}")
    if ck.shape != (B, n_checkpoints(T), D) or ck.dtype != torch.float32 \
            or ck.device != x.device or not ck.is_contiguous():
        raise ValueError(f"{BWD_NAME}: ck must be the forward's contiguous "
                         f"(B, ceil(T/{CHUNK}), D) f32 checkpoints")
    dx = torch.empty((B, T, D), dtype=x.dtype, device=x.device)
    da = torch.empty((B, T, D), dtype=x.dtype, device=x.device)
    if dx.numel() == 0:
        return dx, da
    lib = _lib()
    st = _strides(x, a, dy)
    with torch.cuda.device(x.device):
        rc = lib.rglru_scan_bwd(
            x.data_ptr(), a.data_ptr(), ck.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), da.data_ptr(), ELEM[x.dtype], B, T, D, CHUNK,
            ctypes.addressof(st),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, BWD_NAME)
    _build.launches[BWD_NAME] += 1
    return dx, da


class RGLRUScan(torch.autograd.Function):
    """Differentiable RG-LRU recurrence on the card: the forward kernel
    (with its checkpoints when a gradient is wanted) and the backward
    kernel."""

    @staticmethod
    def forward(ctx, x, a):
        if not any(ctx.needs_input_grad):
            return rglru_scan(x, a)
        y, ck = rglru_scan(x, a, with_state=True)
        ctx.save_for_backward(x, a, ck)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, a, ck = ctx.saved_tensors
        # autograd hands dy in whatever layout the next op's backward made
        dy = dy if dy.stride(-1) == 1 else dy.contiguous()
        return rglru_scan_bwd(x, a, ck, dy)
