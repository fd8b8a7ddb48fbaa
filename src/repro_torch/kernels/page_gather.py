"""CUDA kernels of the paged serving KV cache: the page-table gather
(``csrc/page_gather.cu``) and chunked-prefill attention over the gathered
context (``csrc/prefill_page_attention.cu``).

``page_gather`` replaces the Pallas TPU kernel
``repro/kernels/page_gather.py`` (``page_gather``, ``pallas_call`` at
:57): ``pool[page_table]`` with the page axis folded into the cache axis,
bit for bit.  Bound on the H100: bytes (2x the output).  One block per
(batch row, logical page) reads its own page id and copies the page's
contiguous row with 16-byte vector accesses.  Its plain version is
``ref.page_gather``.

``prefill_page_attention`` replaces the Pallas TPU kernel of the same
name (:107, ``pallas_call`` at :157): a prompt chunk's queries against the
ring context of its earlier chunks and its own keys, masked by absolute
position.  Bound on the H100: bytes at the serving shapes.  One block per
(32 query rows of one kv head's group, kv head, batch row) walks the
context and then the chunk's keys in 64-key tiles, read through strides
from the two sources (no concatenation), skipping a tile only when no key
in it is live for any row of the block.  Its plain version is
``ref.prefill_page_attention``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .flash_attention import ELEM

NAME = "page_gather"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"page_gather_fwd":
              [_P, _P, _P, ctypes.c_longlong, ctypes.c_int,
               ctypes.c_longlong, _P]}
PREFILL_NAME = "prefill_page_attention"
PREFILL_SIGNATURES = {"prefill_page_attention_fwd":
                      [_P] * 8 + [_I] * 7 + [_P, ctypes.c_float, _I, _P]}
MAX_HD = 128        # prefill at head dim 256 comes with recurrent serving


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


def prefill_page_attention(q: torch.Tensor, k_ctx: torch.Tensor,
                           v_ctx: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, ctx_pos: torch.Tensor,
                           q_pos: torch.Tensor,
                           window: int = 0) -> torch.Tensor:
    """q: (B, C, H, hd); k_ctx, v_ctx: (B, L, KV, hd); k_new, v_new:
    (B, C, KV, hd), all CUDA tensors of one dtype with a contiguous head
    dim; ctx_pos: (B, L) and q_pos: (B, C) int32 positions (negative =
    dead slot) with a contiguous position axis; C <= L -> (B, C, H, hd)
    in q's dtype."""
    name = PREFILL_NAME
    ts = (q, k_ctx, v_ctx, k_new, v_new, ctx_pos, q_pos)
    if q.device.type != "cuda" or any(t.device != q.device for t in ts):
        raise ValueError(f"{name}: CUDA tensors on one device only, got "
                         f"{sorted({str(t.device) for t in ts})}")
    if q.dtype not in ELEM or any(t.dtype != q.dtype for t in ts[1:5]):
        raise ValueError(f"{name}: dtypes "
                         f"{[str(t.dtype) for t in ts[:5]]}")
    if any(t.ndim != 4 for t in ts[:5]):
        raise ValueError(f"{name}: q, k, v must be 4-d")
    B, C, H, hd = q.shape
    L, KV = k_ctx.shape[1], k_ctx.shape[2]
    if (v_ctx.shape != k_ctx.shape or k_ctx.shape != (B, L, KV, hd)
            or k_new.shape != (B, C, KV, hd) or v_new.shape != k_new.shape):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, ctx "
                         f"{tuple(k_ctx.shape)}/{tuple(v_ctx.shape)}, new "
                         f"{tuple(k_new.shape)}/{tuple(v_new.shape)}")
    if H % KV:
        raise ValueError(f"{name}: {H} heads over {KV} kv heads")
    if C > L:
        raise ValueError(f"{name}: chunk {C} longer than the ring {L}")
    if hd > MAX_HD:
        raise ValueError(f"{name}: head dim {hd} > {MAX_HD}")
    if any(t.stride(-1) != 1 for t in ts[:5]):
        raise ValueError(f"{name}: head dim must be contiguous")
    for pname, t, n in (("ctx_pos", ctx_pos, L), ("q_pos", q_pos, C)):
        if t.dtype != torch.int32 or t.shape != (B, n) or \
                (n > 1 and t.stride(1) != 1):
            raise ValueError(f"{name}: {pname} must be ({B}, {n}) int32 "
                             "with a contiguous position axis")
    o = torch.empty((B, C, H, hd), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    vals = [s for t in (q, k_ctx, v_ctx, k_new, v_new, o)
            for s in t.stride()[:3]] + [ctx_pos.stride(0), q_pos.stride(0)]
    st = (ctypes.c_longlong * len(vals))(*vals)
    lib = _build.load(name, PREFILL_SIGNATURES)
    with torch.cuda.device(q.device):
        rc = lib.prefill_page_attention_fwd(
            q.data_ptr(), k_ctx.data_ptr(), v_ctx.data_ptr(),
            k_new.data_ptr(), v_new.data_ptr(), ctx_pos.data_ptr(),
            q_pos.data_ptr(), o.data_ptr(), ELEM[q.dtype], B, C, L, H, KV,
            hd, ctypes.addressof(st), hd ** -0.5, int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, name)
    _build.launches[name] += 1
    return o
