"""CUDA kernels of the paged serving KV cache: the page-table gather
(``csrc/page_gather.cu``) and chunked-prefill attention that reads the
context through the page table in place (``csrc/prefill_page_attention.cu``).

``page_gather`` replaces the Pallas TPU kernel
``repro/kernels/page_gather.py`` (``page_gather``, ``pallas_call`` at
:57): ``pool[page_table]`` with the page axis folded into the cache axis,
bit for bit.  Bound on the H100: bytes (2x the output).  One block per
(batch row, logical page) reads its own page id and copies the page's
contiguous row with 16-byte vector accesses.  Its plain version is
``ref.page_gather``.

``prefill_page_attention_paged`` replaces the Pallas TPU kernel
``prefill_page_attention`` (:107, ``pallas_call`` at :157) together with
the ``page_gather`` of the ring before it: a prompt chunk's queries
against the ring context of its earlier chunks, read from the pools
through the page table, and its own keys, masked by absolute position.
Bound on the H100: bytes at the serving shapes.  bf16 runs on the tensor
cores (``mma.sync``; 16-byte ``cp.async`` copies straight from the
pages, so q, the pools and the chunk's K/V need 16-byte aligned pointers
and (b, s, h) strides and a head dim that is a multiple of 8), f32 on the
CUDA cores; head dims up to 256.  :func:`prefill_plan` states the blocks
and the bf16 kernel's split of the keys over blocks where the rows give
too few (partials merged in split order, from the chunk's shape alone,
so a row's bits do not depend on B).  ``prefill_page_attention`` is the JAX
package's form over a gathered context: the same kernel with one page of
L slots per row.  Its plain version is ``ref.page_gather`` followed by
``ref.prefill_page_attention``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .decode_attention import split_counters
from .flash_attention import ELEM

NAME = "page_gather"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"page_gather_fwd":
              [_P, _P, _P, ctypes.c_longlong, ctypes.c_int,
               ctypes.c_longlong, _P]}
PREFILL_NAME = "prefill_page_attention"
PREFILL_SIGNATURES = {"prefill_page_attention_fwd":
                      [_P] * 11 + [_I] * 10 + [_P, ctypes.c_float, _I, _P]}
MAX_HD = 256
ROWS = 32                   # packed query rows a block
SPLIT_BLOCKS = 128          # bf16: split the keys while fewer blocks


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
    _build.count(NAME)
    return out


def prefill_plan(C: int, L: int, H: int, KV: int, hd: int,
                 dtype: torch.dtype) -> dict:
    """The kernel's blocks for one chunk shape, a pure function of (C, L,
    H, KV, hd, dtype), never of B: a row's result does not depend on the
    batch.  ``row_tiles`` blocks of 32 packed rows per (kv head, batch
    row), ``tile`` keys a shared-memory tile, ``key_tiles`` over the L + C
    keys, and ``splits``: in bf16, while row_tiles * KV < 128 blocks the
    key tiles are split over up to 128 // (row_tiles * KV) blocks (at
    least 4 tiles each), their partials merged in split order; f32 never
    splits."""
    row_tiles = -(-(H // KV) * C // ROWS)
    if dtype != torch.bfloat16:
        return dict(row_tiles=row_tiles, tile=64,
                    key_tiles=-(-(L + C) // 64), splits=1)
    tile = 64 if hd > 128 else 128
    n = -(-(L + C) // tile)
    splits = max(1, min(SPLIT_BLOCKS // (row_tiles * KV), n // 4))
    return dict(row_tiles=row_tiles, tile=tile, key_tiles=n, splits=splits)


def prefill_page_attention_paged(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 page_table: torch.Tensor,
                                 k_new: torch.Tensor, v_new: torch.Tensor,
                                 ctx_pos: torch.Tensor, q_pos: torch.Tensor,
                                 window: int = 0) -> torch.Tensor:
    """q: (B, C, H, hd); k_pool, v_pool: (P, page, KV, hd) pools;
    page_table: (B, n_pp) int32 page ids in [0, P); k_new, v_new: (B, C,
    KV, hd), all CUDA tensors of one dtype with a contiguous head dim;
    ctx_pos: (B, L) and q_pos: (B, C) int32 positions (negative = dead
    slot), L = n_pp * page, with a contiguous position axis; C <= L ->
    (B, C, H, hd) in q's dtype: ``ref.prefill_page_attention`` over
    ``ref.page_gather(k_pool, page_table)`` (and v's)."""
    name = PREFILL_NAME
    ts = (q, k_pool, v_pool, k_new, v_new, page_table, ctx_pos, q_pos)
    if q.device.type != "cuda" or any(t.device != q.device for t in ts):
        raise ValueError(f"{name}: CUDA tensors on one device only, got "
                         f"{sorted({str(t.device) for t in ts})}")
    if q.dtype not in ELEM or any(t.dtype != q.dtype for t in ts[1:5]):
        raise ValueError(f"{name}: dtypes "
                         f"{[str(t.dtype) for t in ts[:5]]}")
    if any(t.ndim != 4 for t in ts[:5]):
        raise ValueError(f"{name}: q, the pools and k/v must be 4-d")
    B, C, H, hd = q.shape
    P, page, KV = k_pool.shape[:3]
    if page_table.dtype != torch.int32 or page_table.ndim != 2 or \
            page_table.shape[0] != B or \
            (page_table.shape[1] > 1 and page_table.stride(1) != 1):
        raise ValueError(f"{name}: page_table must be ({B}, n_pp) int32 "
                         "with a contiguous page axis")
    n_pp = page_table.shape[1]
    L = n_pp * page
    if (v_pool.shape != k_pool.shape or k_pool.shape[3] != hd
            or k_new.shape != (B, C, KV, hd) or v_new.shape != k_new.shape):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, new "
                         f"{tuple(k_new.shape)}/{tuple(v_new.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"{name}: {H} heads over {KV} kv heads")
    if C > L:
        raise ValueError(f"{name}: chunk {C} longer than the ring {L}")
    if hd > MAX_HD:
        raise ValueError(f"{name}: head dim {hd} > {MAX_HD}")
    if any(t.stride(-1) != 1 for t in ts[:5]):
        raise ValueError(f"{name}: head dim must be contiguous")
    if q.dtype == torch.bfloat16:
        if hd % 8 or any(t.data_ptr() % 16 or any(s % 8 for s in
                                                  t.stride()[:3])
                         for t in ts[:5]):
            raise ValueError(f"{name}: bf16 needs a head dim that is a "
                             "multiple of 8 and 16-byte aligned rows")
    for pname, t, n in (("ctx_pos", ctx_pos, L), ("q_pos", q_pos, C)):
        if t.dtype != torch.int32 or t.shape != (B, n) or \
                (n > 1 and t.stride(1) != 1):
            raise ValueError(f"{name}: {pname} must be ({B}, {n}) int32 "
                             "with a contiguous position axis")
    o = torch.empty((B, C, H, hd), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    p = prefill_plan(C, L, H, KV, hd, q.dtype)
    n = p["splits"]
    part, counters = None, None
    if n > 1:
        t = 64 if hd <= 64 else 128 if hd <= 128 else 256
        cells = B * KV * p["row_tiles"]
        part = torch.empty(cells * n * 2 * (16 * t + 128),
                           dtype=torch.float32, device=q.device)
        counters = split_counters(q.device, cells)
    vals = [s for t in (q, k_pool, v_pool, k_new, v_new, o)
            for s in t.stride()[:3]] + [page_table.stride(0),
                                        ctx_pos.stride(0), q_pos.stride(0)]
    st = (ctypes.c_longlong * len(vals))(*vals)
    lib = _build.load(name, PREFILL_SIGNATURES)
    with torch.cuda.device(q.device):
        rc = lib.prefill_page_attention_fwd(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            ctx_pos.data_ptr(), q_pos.data_ptr(), o.data_ptr(),
            None if part is None else part.data_ptr(),
            None if counters is None else counters.data_ptr(),
            ELEM[q.dtype], B, C, n_pp, page, P, H, KV, hd, n,
            ctypes.addressof(st), hd ** -0.5, int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, name)
    _build.count(name)
    return o


def prefill_page_attention(q: torch.Tensor, k_ctx: torch.Tensor,
                           v_ctx: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, ctx_pos: torch.Tensor,
                           q_pos: torch.Tensor,
                           window: int = 0) -> torch.Tensor:
    """The JAX package's form over a gathered context k_ctx, v_ctx (B, L,
    KV, hd): :func:`prefill_page_attention_paged` with each row's context
    as one page of L slots (pools (B, L, KV, hd), table ``arange(B)``)."""
    if q.device.type != "cuda":
        raise ValueError(f"{PREFILL_NAME}: CUDA tensors on one device only, "
                         f"got {q.device}")
    table = torch.arange(q.shape[0], dtype=torch.int32,
                         device=q.device)[:, None]
    return prefill_page_attention_paged(q, k_ctx, v_ctx, table, k_new, v_new,
                                        ctx_pos, q_pos, window=window)
