"""Dispatch layer over the port's CUDA kernels and their plain versions.

The models call only these entry points.  The route follows the device of
the tensor: a CPU tensor takes the plain PyTorch version (``ref``); a CUDA
tensor launches the hand-written kernel, which raises on what it does not
take.  There is no environment switch and no fallback from one to the
other.  ``launches`` counts kernel launches per kernel (the wrappers add
one right after each launch).
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from . import ref
from ._build import launches, reset_launches
from .decode_attention import decode_attention as _decode_attention
from .decode_attention import decode_attention_paged as _decode_paged
from .flash_attention import FlashAttention
from .moe_matmul import MoEGroupedFFN
from .page_gather import page_gather as _page_gather
from .page_gather import prefill_page_attention as _prefill_page_attention
from .page_gather import prefill_page_attention_paged as _prefill_paged
from .rglru_scan import RGLRUScan, rglru_scan
from .ring_gather import ring_gather as _ring_gather
from .rwkv6_scan import RWKV6Scan, rwkv6_scan

__all__ = ["attention", "attention_decode", "attention_decode_paged",
           "moe_grouped_ffn", "page_gather",
           "prefill_page_attention", "prefill_page_attention_paged", "rglru",
           "rglru_stateful", "ring_gather", "rwkv6", "rwkv6_stateful",
           "launches",
           "reset_launches", "CHUNK_THRESHOLD"]

# on the CPU, sequences at or above this length take the blockwise path
# (bounded score-matrix memory), as in repro.kernels.ops
CHUNK_THRESHOLD = 4096


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel route for device {t.device}")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """Differentiable on both routes: on the card through
    :class:`FlashAttention` (forward and backward kernels), on the CPU
    through autograd of the plain version.  DTensors (the sharded steps,
    ``launch/sharding.py``) take the same routes on each rank's shard
    (:func:`_attention_sharded`)."""
    if isinstance(q, DTensor):
        return _attention_sharded(q, k, v, causal, window)
    if _on_cuda(q):
        return FlashAttention.apply(q, k, v, causal, window)
    return _attention_plain(q, k, v, causal, window)


def _attention_plain(q, k, v, causal, window):
    S = q.shape[1]
    if S >= CHUNK_THRESHOLD and S % min(1024, S) == 0 \
            and q.shape[1] == k.shape[1]:
        return ref.attention_chunked(q, k, v, causal=causal, window=window)
    return ref.attention(q, k, v, causal=causal, window=window)


def _attention_sharded(q: DTensor, k: DTensor, v: DTensor, causal: bool,
                       window: int) -> DTensor:
    """``attention`` on DTensors (B, S, H, hd): q, k and v are first laid
    out so that each rank's shard is a whole attention problem -- the
    batch split over the mesh dims that already split q's batch, the heads
    over ``model`` when both H and KV divide it (each rank then holds whole
    GQA groups), everything else replicated -- and each rank runs the
    kernel (the plain version on the CPU) on its shard through
    ``local_map``, forward and backward.  The sequence and the head dim
    are never split: a layout that would split them raises."""
    mesh = q.device_mesh
    B, H, KV = q.shape[0], q.shape[2], k.shape[2]
    pl, nb = [], 1
    for i, name in enumerate(mesh.mesh_dim_names):
        size = mesh.size(i)
        if q.placements[i] == Shard(0) and B % (nb * size) == 0:
            pl.append(Shard(0))
            nb *= size
        elif name == "model" and H % size == 0 and KV % size == 0:
            pl.append(Shard(2))
        else:
            pl.append(Replicate())
    if any(isinstance(p, Shard) and p.dim in (1, 3) for p in pl):
        raise ValueError(f"attention cannot run on a shard of the sequence "
                         f"or head dim: {pl}")
    q, k, v = (t.redistribute(mesh, pl) for t in (q, k, v))
    run = local_map(_attention_local, out_placements=pl,
                    in_placements=(pl, pl, pl, None, None),
                    device_mesh=mesh)
    return run(q, k, v, causal, window)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous: a shard's
    gradient leaves ``local_map`` in the strides the plain version's
    backward gave it, and DTensor cannot view a transposed shard."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _attention_local(q, k, v, causal, window):
    """One rank's shard of ``_attention_sharded``; the dry run's ``meta``
    shards take the plain version (the costs of the CPU route)."""
    q, k, v = (_ContiguousGrad.apply(t) for t in (q, k, v))
    if q.device.type == "meta":
        return _attention_plain(q, k, v, causal, window)
    return attention(q, k, v, causal, window)


def _decode_local(q, k, v, valid):
    """One rank's rows of ``_attention_decode_sharded``; ``meta`` shards
    (the dry run's) take the plain version."""
    if q.device.type == "meta":
        return ref.attention_decode(q, k, v, valid)
    return attention_decode(q, k, v, valid)


def attention_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    if isinstance(k, DTensor):
        return _attention_decode_sharded(q, k, v, valid)
    if _on_cuda(q):
        return _decode_attention(q, k, v, valid)
    return ref.attention_decode(q, k, v, valid)


def _decode_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid: torch.Tensor):
    """The plain decode read over one part of the ring: the f32 output
    before normalisation (B, 1, H, hd), the softmax sum (B, H, 1) and the
    max (B, H, 1) of this part's live scores (-inf where it has none)."""
    H = q.shape[2]
    k, v = ref._repeat_kv(k, H), ref._repeat_kv(v, H)
    s = ref._scores(q, k)                                   # (B, H, 1, L)
    vmask = valid[None, :] if valid.ndim == 1 else valid
    s = s.masked_fill(~vmask.bool()[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1)
    p = torch.exp(s - torch.where(torch.isinf(m), 0.0, m)[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o, p.sum(dim=-1), m


def _attention_decode_sharded(q: DTensor, k: DTensor, v: DTensor,
                              valid: DTensor) -> DTensor:
    """``attention_decode`` on a DTensor ring (B, L, KV, hd), its batch
    and its slots split as ``cache_axes`` lays them out (batch over the
    data axes, ``kv_seq`` over ``model``).  Each rank reads its part of
    the ring; the parts combine as flash-decoding's splits do, by an
    all-reduce of the score max, then of the rescaled sums and outputs.
    A ring split over no mesh dim runs the kernel (the plain version off
    the card) on each rank's rows through ``local_map``.  The card has no
    kernel for a part of the ring yet (its output is normalised), so a
    split ring on the card raises."""
    mesh, pl = k.device_mesh, k.placements
    if any(not (p == Shard(0) or p == Shard(1) or p == Replicate())
           for p in pl):
        raise ValueError(f"decode attention: unsupported ring layout {pl}")
    rows = [Shard(0) if p == Shard(0) else Replicate() for p in pl]
    if valid.ndim == 1:         # (L,): split as the ring's slots
        split_valid = [Shard(0) if p == Shard(1) else Replicate()
                       for p in pl]
    else:                       # (B, L): as the ring's rows and slots
        split_valid = [Shard(1) if p == Shard(1) else r
                       for p, r in zip(pl, rows)]
    q = q.redistribute(mesh, rows)
    k, v = k.redistribute(mesh, pl), v.redistribute(mesh, pl)
    valid = valid.redistribute(mesh, split_valid)
    if Shard(1) not in pl:
        run = local_map(_decode_local, out_placements=rows,
                        in_placements=(rows, pl, pl, split_valid),
                        device_mesh=mesh)
        return run(q, k, v, valid)
    if k.to_local().device.type == "cuda":
        raise NotImplementedError(
            "decode attention over a ring split across ranks has no "
            "kernel on the card yet (ROADMAP A10b)")
    o, l, m = _decode_partial(q.to_local(), k.to_local(), v.to_local(),
                              valid.to_local())
    part = [Partial("max") if p == Shard(1) else r for p, r in zip(pl, rows)]
    m_all = DTensor.from_local(m, mesh, part, run_check=False) \
        .redistribute(mesh, rows).to_local()
    scale = torch.exp(torch.where(torch.isinf(m), m, m - m_all))
    part = [Partial("sum") if p == Shard(1) else r for p, r in zip(pl, rows)]
    o, l = (DTensor.from_local(t, mesh, part, run_check=False)
            .redistribute(mesh, rows).to_local()
            for t in (o * scale.permute(0, 2, 1)[..., None], l * scale))
    out = (o / l.permute(0, 2, 1)[..., None]).to(q.dtype)
    return DTensor.from_local(out, mesh, rows, run_check=False)


def attention_decode_paged(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           valid: torch.Tensor) -> torch.Tensor:
    """One query token a row (B, 1, H, hd) against the ring read through
    the page table (B, n_pp) from the pools (P, page, KV, hd), masked by
    ``valid``: on the card one kernel reading the pages in place, on the
    CPU ``page_gather`` of both pools and ``attention_decode``."""
    if _on_cuda(q):
        return _decode_paged(q, k_pool, v_pool, page_table, valid)
    return ref.attention_decode(q, ref.page_gather(k_pool, page_table),
                                ref.page_gather(v_pool, page_table), valid)


def page_gather(pool: torch.Tensor, page_table: torch.Tensor
                ) -> torch.Tensor:
    """Paged-KV logical view: pool (P, page, ...) + page_table (B, n_pp)
    -> (B, n_pp * page, ...)."""
    if _on_cuda(pool):
        return _page_gather(pool, page_table)
    return ref.page_gather(pool, page_table)


def prefill_page_attention(q: torch.Tensor, k_ctx: torch.Tensor,
                           v_ctx: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, ctx_pos: torch.Tensor,
                           q_pos: torch.Tensor,
                           window: int = 0) -> torch.Tensor:
    """One prompt chunk (B, C, H, hd) against its gathered ring context
    (B, L, KV, hd) and its own keys, masked by absolute position."""
    if _on_cuda(q):
        return _prefill_page_attention(q, k_ctx, v_ctx, k_new, v_new,
                                       ctx_pos, q_pos, window=window)
    return ref.prefill_page_attention(q, k_ctx, v_ctx, k_new, v_new,
                                      ctx_pos, q_pos, window=window)


def prefill_page_attention_paged(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 page_table: torch.Tensor,
                                 k_new: torch.Tensor, v_new: torch.Tensor,
                                 ctx_pos: torch.Tensor, q_pos: torch.Tensor,
                                 window: int = 0) -> torch.Tensor:
    """One prompt chunk (B, C, H, hd) against its ring context read through
    the page table (B, n_pp) from the pools (P, page, KV, hd), and its own
    keys: on the card one kernel reading the pages in place, on the CPU
    ``page_gather`` of both pools and ``prefill_page_attention``."""
    if _on_cuda(q):
        return _prefill_paged(q, k_pool, v_pool, page_table, k_new, v_new,
                              ctx_pos, q_pos, window=window)
    return ref.prefill_page_attention(
        q, ref.page_gather(k_pool, page_table),
        ref.page_gather(v_pool, page_table), k_new, v_new, ctx_pos, q_pos,
        window=window)


def ring_gather(hist: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """One stacked version of a packed ring: hist (size, N) and a 0-d
    int32 device index -> hist[idx] (N,), with no host synchronisation."""
    if _on_cuda(hist):
        return _ring_gather(hist, idx)
    return ref.ring_gather(hist, idx)


def moe_grouped_ffn(dispatch: torch.Tensor, combine: torch.Tensor,
                    xg: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                    wd: torch.Tensor) -> torch.Tensor:
    """Grouped-expert SwiGLU FFN over dispatched token groups
    (models/moe.py): dispatch (G, g, E, C) bool, combine (G, g, E, C) f32,
    xg (G, g, d), wg/wu (E, d, f), wd (E, f, d) -> (G, g, d).
    Differentiable on both routes (in combine, xg and the weights): on the
    card through :class:`MoEGroupedFFN` (forward and backward kernels), on
    the CPU through autograd of the plain version, the JAX package's own
    route."""
    if _on_cuda(xg):
        return MoEGroupedFFN.apply(dispatch, combine, xg, wg, wu, wd)
    return ref.moe_grouped_ffn(dispatch, combine, xg, wg, wu, wd)


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
          u: torch.Tensor) -> torch.Tensor:
    """The RWKV-6 WKV recurrence from a zero state (models/rwkv6.py): r, k,
    v (B, T, H, hd) in the compute dtype, w (B, T, H, hd) f32, u (H, hd) ->
    (B, T, H, hd) in r's dtype.  Differentiable on both routes: on the card
    through :class:`RWKV6Scan` (forward and backward kernels), on the CPU
    through autograd of the plain version."""
    if _on_cuda(r):
        return RWKV6Scan.apply(r, k, v, w, u)
    return ref.rwkv6(r, k, v, w, u)


def rwkv6_stateful(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, S0: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The recurrence from the state S0 (B, H, hd, hd) f32 -> (y in r's
    dtype, the state after the last step in f32): serving's prefill, its
    chunks and its decode steps (T = 1).  On the card the WKV forward
    kernel from S0 at every T, on the CPU the plain version (the JAX
    package runs the plain version on every device).  No gradient."""
    if _on_cuda(r):
        return rwkv6_scan(r, k, v, w, u.float(), S0=S0.float())
    return ref.rwkv6_stateful(r, k, v, w, u, S0)


def rglru(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The RG-LRU recurrence from a zero state (models/rglru.py): x, a
    (B, T, D) in the compute dtype -> h (B, T, D) in x's dtype.
    Differentiable on both routes: on the card through :class:`RGLRUScan`
    (forward and backward kernels), on the CPU through autograd of the
    plain version."""
    if _on_cuda(x):
        return RGLRUScan.apply(x, a)
    return ref.rglru(x, a)[0]


def rglru_stateful(x: torch.Tensor, a: torch.Tensor, h0: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU recurrence from the state h0 (B, D) f32 -> (h (B, T, D)
    in x's dtype, the state after the last step (B, D) f32): serving's
    prefill, its chunks and its decode steps (T = 1).  On the card the
    forward kernel from h0 at every T (the final state is its last
    checkpoint), on the CPU the plain version, as the JAX package's
    ``rglru_stateful``.  No gradient."""
    if _on_cuda(x):
        h, ck = rglru_scan(x, a, h0=h0.float(), with_state=True)
        return h, ck[:, -1]
    return ref.rglru(x, a, h0)
