"""CUDA WKV recurrence of RWKV-6 for training and serving
(``csrc/rwkv6_scan.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/rwkv6_scan.py``
(``rwkv6_scan``, ``pallas_call`` at :73): per (batch, head) an (hd, hd) f32
state, y_t = r_t S_t + (r_t . (u * k_t)) v_t and S_{t+1} = diag(w_t) S_t +
k_t v_t^T.  r, k, v in the compute dtype, the decay w in f32 (as the model
makes it), u (H, hd) in f32; y in r's dtype.  Any T, read through strides
in the (B, T, H, hd) layout (rows 16-byte aligned; others are copied
first), head dims 16 (the smoke config) and 64.  Bound on the H100:
operations (5 hd^2 f32 FLOPs a step).  Its plain version is ``ref.rwkv6``.
Serving runs the forward from a carried state ``S0`` (B, H, hd, hd) f32
and takes the state after step T - 1 out (``ops.rwkv6_stateful``, whose
plain version is ``ref.rwkv6_stateful``; the JAX package runs that
stateful form through its plain version); a null ``S0`` gives the zero
state's bits.  The final state comes back in a fresh tensor, never in
``S0``'s storage.

Chunk-parallel: a chunk of ``CHUNK`` steps acts on the state as S ->
a (.) S + dS (a the product of its decays), so one kernel writes each
chunk's summary (a, dS) from a zero state and a second folds the earlier
summaries into each chunk's start state and walks only that chunk, one
block per (chunk, 16-column slice, h, b).  No block walks more than
``CHUNK`` steps.  :func:`plan` gives the chunk, grids, threads, shared
memory and scratch from the shapes alone.

Training needs the gradient, which the Pallas kernel never had (the JAX
package trains through autodiff of the ``lax.scan`` in its plain
version).  :class:`RWKV6Scan` wraps the forward, which then also writes the
state every ``CHUNK`` steps, and the backward (``rwkv6_scan_bwd``: dr, dk,
dv in r's dtype, dw and du in f32): the adjoint's chunk summaries, dv from
the forward's walk kernel run backward in time on the adjoint, dr, dk, dw
from 16-row slices that rebuild each chunk's states from its checkpoint in
two levels (never by dividing by w), and du summed over (batch, chunk) in
f64 in a fixed order; deterministic, no atomics.  Its oracle is torch
autograd through ``ref.rwkv6``.  The two are counted apart in
``_build.launches``, one launch per wrapper call, however many kernels the
call runs.
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
    "rwkv6_scan_tiles": [_I, _I, _I],
    "rwkv6_scan_fwd": [_P] * 10 + [_I] * 6 + [_P, _P],
    "rwkv6_scan_bwd": [_P] * 14 + [_I] * 6 + [_P, _P],
}
# csrc/rwkv6_scan.cu: CK, SEG, SUB, TS, SUM_COLS, WALK_COLS, BWD_ROWS
CHUNK = 64          # steps a block walks; the checkpoint interval
SEG = 16            # the backward: steps staged at once, level-1 states
SUB = 4             # the backward's sub-chunk, its states in shared memory
TILE = 8            # steps staged at a time by the column kernels
SUM_COLS = 16       # state columns of a summary block
WALK_COLS = 16      # state columns of a forward / dv walk block
BWD_ROWS = 16       # state rows of a backward walk block
KERNELS = ("fwd_sum", "fwd", "bwd_sum", "bwd_dv", "bwd")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(B: int, T: int, H: int, hd: int) -> dict:
    """The kernels' launch numbers for one shape, from the shapes alone:
    ``chunk``, ``nc`` chunks, the backward's ``seg`` (steps staged at once,
    states kept in registers at its boundaries) and ``sub`` (steps whose
    states it keeps in shared memory), and per
    kernel (``fwd_sum``, ``fwd``, ``bwd_sum``, ``bwd_dv``, ``bwd``, ``du``)
    its ``grid`` (x, y, z) = (chunks x slices, H, B), ``blocks``,
    ``threads``, ``slices`` of the state and their ``width`` (columns, rows
    for ``bwd``), and shared memory ``smem`` (static, or the dynamic size
    ``bwd`` asks for); the f32 ``scratch_bytes`` of the chunk summaries,
    the ``checkpoint_bytes`` and the f64 ``du_part_bytes``.  The summary
    kernels run over every chunk (as many blocks as the walks; the forward
    never reads the last chunk's summary, the backward never the first's),
    and not at all when T <= chunk."""
    nc = _cdiv(T, CHUNK)
    # staged rows of one step: a walk lane reads hd/8 rows, a summary lane
    # hd/16; groups of 8 or more rows sit 4 floats apart (bank spread)
    walk_len = hd + (hd // 8 >= 8) * 8 * 4
    smem_sum = 4 * TILE * (2 * walk_len + SUM_COLS)
    smem_walk = 4 * TILE * (3 * walk_len + WALK_COLS + 1)
    bwd_threads = BWD_ROWS // 2 * hd // 8
    smem_bwd = 4 * (SUB * 16 * bwd_threads + 3 * SEG * BWD_ROWS
                    + 2 * SEG * hd + SEG)

    def kern(chunks, width, threads, smem):
        slices = hd // width
        grid = (chunks * slices, H, B)
        return dict(grid=grid, blocks=grid[0] * H * B, threads=threads,
                    slices=slices, width=width, smem=smem)

    kernels = dict(
        fwd_sum=kern(nc if nc > 1 else 0, SUM_COLS, 32, smem_sum),
        fwd=kern(nc, WALK_COLS, 32, smem_walk),
        bwd_sum=kern(nc if nc > 1 else 0, SUM_COLS, 32, smem_sum),
        bwd_dv=kern(nc, WALK_COLS, 32, smem_walk),
        bwd=kern(nc, BWD_ROWS, bwd_threads, smem_bwd))
    kernels["du"] = dict(grid=(_cdiv(H * hd, 256), 1, 1),
                         blocks=_cdiv(H * hd, 256), threads=256, slices=1,
                         width=H * hd, smem=0)
    return dict(chunk=CHUNK, nc=nc, seg=SEG, sub=SUB, **kernels,
                scratch_bytes=4 * B * H * nc * hd * (hd + 1),
                checkpoint_bytes=4 * B * H * nc * hd * hd,
                du_part_bytes=8 * B * nc * H * hd)


def chunk() -> int:
    """The checkpoint interval, ``CK`` in csrc/rwkv6_scan.cu."""
    return CHUNK


def n_checkpoints(T: int) -> int:
    return _cdiv(T, CHUNK)


def kernel_tiles(hd: int) -> dict:
    """The built library's own numbers, to hold :func:`plan` to: its chunk,
    and {kernel: (shared-memory bytes, threads, width)} at head dim hd."""
    lib = _lib()
    return dict(chunk=lib.rwkv6_scan_ck(), **{
        name: tuple(lib.rwkv6_scan_tiles(i, hd, what) for what in range(3))
        for i, name in enumerate(KERNELS)})


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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when every (b, t, h) row starts on a 16-byte boundary
    (the kernels read rows in 16-byte pieces), else a copy in a fresh,
    aligned allocation."""
    e = t.element_size()
    ok = t.data_ptr() % 16 == 0 and all(
        n == 1 or s * e % 16 == 0 for n, s in zip(t.shape[:3], t.stride()))
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def _lib() -> ctypes.CDLL:
    return _build.load(NAME, SIGNATURES)


def _scratch(p: dict, device) -> torch.Tensor | None:
    """The f32 chunk summaries of ``plan`` (none with a single chunk)."""
    if p["nc"] < 2:
        return None
    return torch.empty(p["scratch_bytes"] // 4, dtype=torch.float32,
                       device=device)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               S0: torch.Tensor | None = None, with_state: bool = False):
    """r, k, v (B, T, H, hd) CUDA tensors of one dtype, w (B, T, H, hd) f32,
    u (H, hd) f32, from the state ``S0`` (B, H, hd, hd) f32 (zero when
    None) -> y (B, T, H, hd) in r's dtype; with ``with_state`` also ckpt
    (B, H, ceil(T / chunk()), hd, hd) f32, the state before steps 0,
    chunk(), 2 chunk(), ...; with ``S0`` given also the state after step
    T - 1 (B, H, hd, hd) f32, a new tensor.  Returns y alone, or the tuple
    (y, [ckpt], [final])."""
    _check(r, k, v, w, u, NAME)
    B, T, H, hd = r.shape
    if S0 is not None:
        if S0.shape != (B, H, hd, hd) or S0.dtype != torch.float32 \
                or S0.device != r.device or T < 1:
            raise ValueError(f"{NAME}: S0 must be ({B}, {H}, {hd}, {hd}) "
                             f"float32 on {r.device} with T >= 1, got "
                             f"{tuple(S0.shape)} {S0.dtype} {S0.device}, "
                             f"T {T}")
        S0 = S0.contiguous()
    y = torch.empty((B, T, H, hd), dtype=r.dtype, device=r.device)
    ckpt = torch.empty((B, H, n_checkpoints(T), hd, hd), dtype=torch.float32,
                       device=r.device) if with_state else None
    final = torch.empty((B, H, hd, hd), dtype=torch.float32,
                        device=r.device) if S0 is not None else None
    if y.numel():
        r, k, v, w = (_aligned(t) for t in (r, k, v, w))
        p = plan(B, T, H, hd)
        summ = _scratch(p, r.device)
        lib = _lib()
        st = _strides(r, k, v, w, y)
        with torch.cuda.device(r.device):
            rc = lib.rwkv6_scan_fwd(
                r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), y.data_ptr(),
                None if ckpt is None else ckpt.data_ptr(),
                None if summ is None else summ.data_ptr(),
                None if S0 is None else S0.data_ptr(),
                None if final is None else final.data_ptr(), ELEM[r.dtype],
                B, T, H, hd, p["chunk"], ctypes.addressof(st),
                torch.cuda.current_stream(r.device).cuda_stream)
        _build.check(lib, rc, NAME)
        _build.count(NAME)
    out = (y,) + ((ckpt,) if with_state else ()) \
        + ((final,) if final is not None else ())
    return out if len(out) > 1 else y


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
    r, k, v, w, dy = (_aligned(t) for t in (r, k, v, w, dy))
    p = plan(B, T, H, hd)
    summ = _scratch(p, r.device)
    du_part = torch.empty((B, p["nc"], H, hd), dtype=torch.float64,
                          device=r.device)
    lib = _lib()
    st = _strides(r, k, v, w, dy, *grads, dw)
    with torch.cuda.device(r.device):
        rc = lib.rwkv6_scan_bwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), ckpt.data_ptr(), dy.data_ptr(),
            *(g.data_ptr() for g in grads), dw.data_ptr(),
            None if summ is None else summ.data_ptr(), du_part.data_ptr(),
            du.data_ptr(), ELEM[r.dtype], B, T, H, hd, p["chunk"],
            ctypes.addressof(st),
            torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(lib, rc, BWD_NAME)
    _build.count(BWD_NAME)
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
