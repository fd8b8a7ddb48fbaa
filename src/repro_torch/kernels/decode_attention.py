"""CUDA single-token decode attention (``csrc/decode_attention.cu``).

``decode_attention_paged`` replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py`` (``decode_attention``,
``pallas_call`` at :102) together with the two ``page_gather`` calls
before it (``repro/kernels/page_gather.py``, ``pallas_call`` at :57):
GQA attention of one query token per row over the paged KV cache's ring,
its K/V rows read in place from the page pools through the page table,
masked by ``valid``; no view of the ring is written.  ``decode_attention``
is the JAX package's form over a gathered ring, the same kernel with one
page of L slots per row, so the two forms give the same bits.
Bound on the H100: bytes (the live K and V rows, read once); what held the
first design back was latency, one serial walk of the ring per (batch row,
kv head).  The kernel splits the ring (flash-decoding): a grid of (split,
kv head, batch row) blocks, each serving the whole query group over a
fixed range of slots and writing a partial (m, l, acc) in f32; the last
block of each (batch row, kv head) merges the partials in split order.
:func:`plan` picks the split from (L, hd, dtype) alone, so a row's bits
do not depend on the batch.  bf16 runs on the tensor cores (``mma.sync``,
the query group as the 16 rows of the product), f32 on the CUDA cores;
both take q and the pools with 16-byte aligned rows.  The plain version
is ``ref.attention_decode`` (over ``ref.page_gather`` of both pools for
the paged form).  ``decode_attention_partial`` is the gathered form whose
merge writes the unnormalised state (acc, l, m) of its part of a ring split
across ranks, for the caller to combine with the other parts'.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .flash_attention import ELEM

NAME = "decode_attention"
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
PAGED_NAME = "decode_attention_paged"
SIGNATURES = {"decode_attention_fwd":
              [_P] * 11 + [_I] * 10 + [_LL] * 12 + [ctypes.c_float, _P]}
HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 16
TILE_BYTES = 8192           # f32: one K (or V) tile in shared memory
TC_TILE = 64                # bf16: keys a tile, 16 a warp
MIN_KEYS_PER_SPLIT = 128
MAX_SPLITS = 64

# per (device, stream): split counters of the decode and chunked-prefill
# kernels, zero between launches (the merging block resets its own); grown
# on demand.  One stream runs one launch at a time, so they share them.
_counters: dict[tuple[int, int], torch.Tensor] = {}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(L: int, hd: int, dtype: torch.dtype) -> dict:
    """The split of an L-slot ring, a pure function of (L, hd, dtype),
    never of B or of the mask: ``hd_tile`` (the padded head dim),
    ``tile`` (keys a shared-memory tile: 64 in bf16, 8 KB of K in f32),
    ``keys_per_split``
    (at least 128, a multiple of the tile; more only past 64 splits) and
    ``splits`` = ceil(L / keys_per_split)."""
    t = 64 if hd <= 64 else 128 if hd <= 128 else 256
    tile = TILE_BYTES // (t * 4) if dtype == torch.float32 else TC_TILE
    kps = max(MIN_KEYS_PER_SPLIT, _cdiv(L, MAX_SPLITS))
    kps = _cdiv(kps, tile) * tile
    return dict(hd_tile=t, tile=tile, keys_per_split=kps,
                splits=_cdiv(L, kps), threads=128)


def split_counters(device: torch.device, n: int) -> torch.Tensor:
    """At least n zeroed int32 counters for the current stream of
    ``device``."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    c = _counters.get(key)
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _counters[key] = c
    return c


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            table: torch.Tensor | None, valid: torch.Tensor,
            name: str, partial: bool = False):
    """One launch over pools k, v (P, page, KV, hd) read through ``table``
    (B, n_pp) int32, or, with no table, over the gathered ring k, v (B, L,
    KV, hd) as B pages of L slots.  Checks what the kernel takes.
    ``partial``: the merged (acc, l, m) of :func:`decode_attention_partial`
    instead of the output."""
    ts = (q, k, v) + (() if table is None else (table,)) + (valid,)
    if q.device.type != "cuda" or any(t.device != q.device for t in ts):
        raise ValueError(f"{name}: CUDA tensors on one device only, got "
                         f"{sorted({str(t.device) for t in ts})}")
    if q.dtype not in ELEM or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 4 or q.shape[1] != 1 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: shapes {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    B, _, H, hd = q.shape
    P, page, KV = k.shape[:3]
    if table is None:
        L = page
        if P != B:
            raise ValueError(f"{name}: q {tuple(q.shape)} vs k "
                             f"{tuple(k.shape)}")
    else:
        if table.dtype != torch.int32 or table.ndim != 2 or \
                table.shape[0] != B or \
                (table.shape[1] > 1 and table.stride(1) != 1):
            raise ValueError(f"{name}: page_table must be ({B}, n_pp) int32 "
                             "with a contiguous page axis")
        L = table.shape[1] * page
    if k.shape[3] != hd or KV == 0 or H % KV:
        raise ValueError(f"{name}: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if hd not in HEAD_DIMS or H // KV > MAX_GROUP:
        raise ValueError(f"{name}: head dim {hd} (want one of {HEAD_DIMS}) "
                         f"or group {H // KV} (max {MAX_GROUP})")
    vec = 16 // q.element_size()          # 16-byte vector loads
    for tname, t in (("q", q), ("k", k), ("v", v)):
        if (t.stride(-1) != 1 or t.data_ptr() % 16
                or any(s % vec for s in t.stride()[:3])):
            raise ValueError(f"{name}: {tname} rows must be contiguous and "
                             "16-byte aligned")
    if valid.shape not in ((L,), (B, L)):
        raise ValueError(f"{name}: valid {tuple(valid.shape)} vs L={L}")
    if valid.dtype != torch.bool:
        valid = valid != 0
    if L > 1 and valid.stride(-1) != 1:
        valid = valid.contiguous()
    live = valid.view(torch.uint8).expand(B, L)   # a bool mask: no copy
    if partial:
        o = torch.empty((B, 1, H, hd), dtype=torch.float32, device=q.device)
        lm = torch.empty((2, B, H, 1), dtype=torch.float32, device=q.device)
        if o.numel() == 0 or L == 0:
            return o.zero_(), lm[0].zero_(), lm[1].fill_(float("-inf"))
    else:
        o = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
        if o.numel() == 0 or L == 0:
            return o.zero_()
    p = plan(L, hd, q.dtype)
    n = p["splits"]
    part, counters = None, None
    if n > 1:
        part = torch.empty(B * KV * n * (H // KV) * (p["hd_tile"] + 2),
                           dtype=torch.float32, device=q.device)
        counters = split_counters(q.device, B * KV)
    lib = _build.load(NAME, SIGNATURES)
    with torch.cuda.device(q.device):
        rc = lib.decode_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if table is None else table.data_ptr(), live.data_ptr(),
            None if partial else o.data_ptr(),
            None if part is None else part.data_ptr(),
            None if counters is None else counters.data_ptr(),
            o.data_ptr() if partial else None,
            lm[0].data_ptr() if partial else None,
            lm[1].data_ptr() if partial else None,
            ELEM[q.dtype], B, L, H, KV, hd, page, P, p["keys_per_split"], n,
            q.stride(0), q.stride(2), *k.stride()[:3], *v.stride()[:3],
            0 if table is None else table.stride(0), live.stride(0),
            o.stride(0), o.stride(2), hd ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, name)
    _build.count(NAME)
    return (o, lm[0], lm[1]) if partial else o


def decode_attention_paged(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           valid: torch.Tensor) -> torch.Tensor:
    """q: (B, 1, H, hd); k_pool, v_pool: (P, page, KV, hd) pools;
    page_table: (B, n_pp) int32 page ids in [0, P) with a contiguous page
    axis; valid: (L,) or (B, L) bool, L = n_pp * page; hd in
    ``HEAD_DIMS``, H / KV at most ``MAX_GROUP``, rows 16-byte aligned ->
    (B, 1, H, hd) in q's dtype: ``ref.attention_decode`` over
    ``ref.page_gather`` of both pools, read in place (a row with no live
    slot gives 0; a page id outside [0, P) traps).  Counts its launches
    under ``decode_attention``."""
    return _launch(q, k_pool, v_pool, page_table, valid, PAGED_NAME)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """The JAX package's form over a gathered ring k, v (B, L, KV, hd):
    :func:`decode_attention_paged` with each row's ring as one page of L
    slots and no table (row b reads page b); valid: (L,) or (B, L) bool ->
    (B, 1, H, hd) in q's dtype."""
    return _launch(q, k, v, None, valid, NAME)


def decode_attention_partial(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, valid: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """One part of a ring split across ranks (the sharded decode of
    ``ops._attention_decode_sharded``): :func:`decode_attention`'s read of
    k, v (B, L, KV, hd) under valid (L,) or (B, L), returning its merged
    state instead of the output -- acc (B, 1, H, hd) f32 before
    normalisation, the softmax sum l and the score max m (B, H, 1) f32, m
    in natural-log units; a row with no live slot gives m = -inf, l = 0,
    acc = 0 (``ops._decode_partial``'s contract).  The same kernel and
    reads as the gathered form; counted under ``decode_attention``."""
    return _launch(q, k, v, None, valid, "decode_attention_partial",
                   partial=True)
