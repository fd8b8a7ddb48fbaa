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
from .decode_attention import decode_attention_partial as _decode_part
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
    the ring -- on the card the decode kernel's partial form, which
    returns its part's unnormalised output, sum and max
    (``decode_attention_partial``), off it :func:`_decode_partial` -- and
    the parts combine as flash-decoding's splits do, by an all-reduce of
    the score max, then of the rescaled sums and outputs.  A ring split
    over no mesh dim runs the kernel (the plain version off the card) on
    each rank's rows through ``local_map``."""
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
    read = (_decode_part if k.to_local().device.type == "cuda"
            else _decode_partial)
    o, l, m = read(q.to_local(), k.to_local(), v.to_local(),
                   valid.to_local())

    def all_reduce(t, op):
        part = [Partial(op) if p == Shard(1) else r
                for p, r in zip(pl, rows)]
        return DTensor.from_local(t, mesh, part, run_check=False) \
            .redistribute(mesh, rows).to_local()
    out = combine_parts(o, l, m, lambda t: all_reduce(t, "max"),
                        lambda t: all_reduce(t, "sum"))
    return DTensor.from_local(out.to(q.dtype), mesh, rows, run_check=False)


def combine_parts(o: torch.Tensor, l: torch.Tensor, m: torch.Tensor,
                  all_max, all_sum) -> torch.Tensor:
    """The decode output (f32) of a ring read in parts, from each part's
    unnormalised output o (..., B, 1, H, hd), sum l and max m (..., B, H,
    1) (:func:`_decode_partial`'s, or the kernel's partial form):
    ``all_max`` / ``all_sum`` reduce over the parts (the ranks'
    all-reduces; a stacked leading dim off a mesh), and the parts
    rescale to the global max as flash-decoding's splits do."""
    m_all = all_max(m)
    scale = torch.exp(torch.where(torch.isinf(m), m, m - m_all))
    o = all_sum(o * scale.transpose(-1, -2)[..., None])
    l = all_sum(l * scale)
    return o / l.transpose(-1, -2)[..., None]


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
                    wd: torch.Tensor, ep=None) -> torch.Tensor:
    """Grouped-expert SwiGLU FFN over dispatched token groups
    (models/moe.py): dispatch (G, g, E, C) bool, combine (G, g, E, C) f32,
    xg (G, g, d), wg/wu (E, d, f), wd (E, f, d) -> (G, g, d).
    Differentiable on both routes (in combine, xg and the weights): on the
    card through :class:`MoEGroupedFFN` (forward and backward kernels), on
    the CPU through autograd of the plain version, the JAX package's own
    route.  ``ep`` lays the plain route's dispatched intermediates out
    (``models/moe.py``'s expert-parallel hook); the kernel never makes
    them and ignores it, as JAX's Pallas route does.  DTensors take
    :func:`_moe_sharded`."""
    if isinstance(xg, DTensor):
        return _moe_sharded(dispatch, combine, xg, wg, wu, wd, ep)
    if _on_cuda(xg):
        return MoEGroupedFFN.apply(dispatch, combine, xg, wg, wu, wd)
    return ref.moe_grouped_ffn(dispatch, combine, xg, wg, wu, wd, ep=ep)


def _moe_sharded(dispatch: DTensor, combine: DTensor, xg: DTensor,
                 wg: DTensor, wu: DTensor, wd: DTensor, ep) -> DTensor:
    """``moe_grouped_ffn`` on DTensors.  Each rank's shard is a whole
    grouped FFN: the token groups G split over the mesh dims that already
    split xg's groups (the weights whole there: ``device.param_for``'s
    read), and over ``model`` the weights as the sharding rules lay them
    out -- the experts (dim 0) where E divides the axis, with dispatch and
    combine split on E to match, else the ffn dim (``wg``/``wu`` dim 2,
    ``wd`` dim 1) where f divides it.  Either way each rank's output is a
    partial sum over ``model`` (``Partial("sum")``, which the residual
    reduces).  Each rank runs the kernel (the plain version off the card)
    on its shard through ``local_map``, forward and backward; an input
    that a ``model`` split leaves whole gets a partial gradient there, as
    a weight does over the group dims.  With the expert-parallel hook
    (``ep``) off the card, the plain version runs on the DTensors
    themselves instead, so that the hook can lay its intermediates out."""
    mesh = xg.device_mesh
    G, E, f = xg.shape[0], wg.shape[0], wg.shape[2]
    R, P = Replicate(), Partial()
    # per mesh dim: (xg, dispatch/combine, wg/wu, wd) placements, and the
    # gradients' of xg, combine and the weights (None: the input's own)
    dims, nb = [], 1
    for i, name in enumerate(mesh.mesh_dim_names):
        size = mesh.size(i)
        if xg.placements[i] == Shard(0) and G % (nb * size) == 0:
            nb *= size
            dims.append((Shard(0), Shard(0), R, R, None, None, P))
        elif name == "model" and E % size == 0:       # experts
            dims.append((R, Shard(2), Shard(0), Shard(0), P, None, None))
        elif name == "model" and f % size == 0:       # their ffn dim
            dims.append((R, R, Shard(2), Shard(1), P, P, None))
        else:
            dims.append((R, R, R, R, None, None, None))
    rows, dc, w_in, wd_in = ([d[j] for d in dims] for j in range(4))
    out = [Shard(0) if d[0] == Shard(0) else R if d[4] is None
           else Partial("sum") for d in dims]

    def grad(j, own):
        return [own[i] if d[j] is None else d[j] for i, d in enumerate(dims)]
    dispatch, combine = (t.redistribute(mesh, dc) for t in (dispatch,
                                                             combine))
    xg = xg.redistribute(mesh, rows)
    wg, wu = (t.redistribute(mesh, w_in) for t in (wg, wu))
    wd = wd.redistribute(mesh, wd_in)
    if ep is not None and xg.to_local().device.type != "cuda":
        return ref.moe_grouped_ffn(dispatch, combine, xg, wg, wu, wd, ep=ep)
    g_w = grad(6, w_in)
    run = local_map(_moe_local, out_placements=out,
                    in_placements=(dc, dc, rows, w_in, w_in, wd_in),
                    in_grad_placements=(dc, grad(5, dc), grad(4, rows), g_w,
                                        g_w, grad(6, wd_in)),
                    device_mesh=mesh)
    return run(dispatch, combine, xg, wg, wu, wd)


def _moe_local(dispatch, combine, xg, wg, wu, wd):
    """One rank's shard of ``_moe_sharded``: the kernel on the card, the
    plain version on the CPU and on ``meta`` (the dry run's)."""
    if xg.device.type == "meta":
        return ref.moe_grouped_ffn(dispatch, combine, xg, wg, wu, wd)
    return moe_grouped_ffn(dispatch, combine, xg.contiguous(),
                           wg.contiguous(), wu.contiguous(),
                           wd.contiguous())


def _scan_layout(x: DTensor, n_feat: int, feat_dim: int) -> list:
    """Placements of a recurrence's (B, T, ...) input whose shards are
    whole recurrences: the batch over the mesh dims that already split
    x's, the feature dim ``feat_dim`` (rwkv6's heads, the RG-LRU's
    width) over ``model`` where ``n_feat`` divides it, the rest whole."""
    mesh, B = x.device_mesh, x.shape[0]
    pl, nb = [], 1
    for i, name in enumerate(mesh.mesh_dim_names):
        size = mesh.size(i)
        if x.placements[i] == Shard(0) and B % (nb * size) == 0:
            pl.append(Shard(0))
            nb *= size
        elif name == "model" and n_feat % size == 0:
            pl.append(Shard(feat_dim))
        else:
            pl.append(Replicate())
    return pl


def _scan_sharded(local, xs: tuple, pl: list, extra: tuple,
                  extra_pl: tuple, extra_grad: tuple, out_pl) -> DTensor:
    """Run ``local`` on each rank's shard of the recurrence inputs ``xs``
    (laid out by ``pl``: the sequence and the last dim are never split,
    ``REPRO_SP=1``'s sequence split is gathered first) and of ``extra``
    (``u``, the initial state; ``extra_pl`` and their gradients'
    ``extra_grad``) through ``local_map``."""
    mesh = xs[0].device_mesh
    xs = tuple(t.redistribute(mesh, pl) for t in xs)
    extra = tuple(t.redistribute(mesh, p) for t, p in zip(extra, extra_pl))
    run = local_map(local, out_placements=out_pl,
                    in_placements=(pl,) * len(xs) + tuple(extra_pl),
                    in_grad_placements=(pl,) * len(xs) + tuple(extra_grad),
                    device_mesh=mesh)
    return run(*xs, *extra)


def _heads_of(pl: list, dim_map: dict) -> list:
    """``pl`` re-indexed for another tensor: Shard(d) -> Shard(dim_map[d])
    (Replicate where d has no counterpart)."""
    return [Shard(dim_map[p.dim]) if isinstance(p, Shard) and p.dim in
            dim_map else Replicate() for p in pl]


def _grad_of(pl: list) -> list:
    """The gradient layout of an input that ``pl``'s batch split leaves
    whole: partial sums over those mesh dims."""
    return [Partial() if p == Shard(0) else q
            for p, q in zip(pl, _heads_of(pl, {2: 0}))]


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
          u: torch.Tensor) -> torch.Tensor:
    """The RWKV-6 WKV recurrence from a zero state (models/rwkv6.py): r, k,
    v (B, T, H, hd) in the compute dtype, w (B, T, H, hd) f32, u (H, hd) ->
    (B, T, H, hd) in r's dtype.  Differentiable on both routes: on the card
    through :class:`RWKV6Scan` (forward and backward kernels), on the CPU
    through autograd of the plain version.  DTensors run on each rank's
    batch rows and heads (:func:`_scan_layout`)."""
    if isinstance(r, DTensor):
        pl = _scan_layout(r, r.shape[2], 2)
        return _scan_sharded(_rwkv6_local, (r, k, v, w), pl, (u,),
                             (_heads_of(pl, {2: 0}),), (_grad_of(pl),), pl)
    if _on_cuda(r):
        return RWKV6Scan.apply(r, k, v, w, u)
    return ref.rwkv6(r, k, v, w, u)


def _rwkv6_local(r, k, v, w, u):
    if r.device.type == "meta":
        return _standin(ref.rwkv6, (r, k, v, w, u), 4)
    return rwkv6(r, k, v, w, u)


def rwkv6_stateful(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, S0: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The recurrence from the state S0 (B, H, hd, hd) f32 -> (y in r's
    dtype, the state after the last step in f32): serving's prefill, its
    chunks and its decode steps (T = 1).  On the card the WKV forward
    kernel from S0 at every T, on the CPU the plain version (the JAX
    package runs the plain version on every device).  No gradient.
    DTensors run as :func:`rwkv6`'s; the state comes back in S0's
    layout."""
    if isinstance(r, DTensor):
        pl = _scan_layout(r, r.shape[2], 2)
        spl = _heads_of(pl, {0: 0, 2: 1})
        y, S = _scan_sharded(_rwkv6_stateful_local, (r, k, v, w), pl,
                             (u, S0), (_heads_of(pl, {2: 0}), spl),
                             (_grad_of(pl), spl), (pl, spl))
        return y, S.redistribute(S0.device_mesh, S0.placements)
    if _on_cuda(r):
        return rwkv6_scan(r, k, v, w, u.float(), S0=S0.float())
    return ref.rwkv6_stateful(r, k, v, w, u, S0)


def _rwkv6_stateful_local(r, k, v, w, u, S0):
    if r.device.type == "meta":
        return _standin(ref.rwkv6_stateful, (r, k, v, w, u, S0), 4)
    return rwkv6_stateful(r, k, v, w, u, S0)


def rglru(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The RG-LRU recurrence from a zero state (models/rglru.py): x, a
    (B, T, D) in the compute dtype -> h (B, T, D) in x's dtype.
    Differentiable on both routes: on the card through :class:`RGLRUScan`
    (forward and backward kernels), on the CPU through autograd of the
    plain version.  DTensors run on each rank's batch rows and channels
    (elementwise over D: :func:`_scan_layout`)."""
    if isinstance(x, DTensor):
        pl = _scan_layout(x, x.shape[2], 2)
        return _scan_sharded(_rglru_local, (x, a), pl, (), (), (), pl)
    if _on_cuda(x):
        return RGLRUScan.apply(x, a)
    return ref.rglru(x, a)[0]


def _rglru_plain(x, a):
    return ref.rglru(x, a)[0]


def _rglru_local(x, a):
    if x.device.type == "meta":
        return _standin(_rglru_plain, (x, a), 2)
    return rglru(x, a)


def rglru_stateful(x: torch.Tensor, a: torch.Tensor, h0: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU recurrence from the state h0 (B, D) f32 -> (h (B, T, D)
    in x's dtype, the state after the last step (B, D) f32): serving's
    prefill, its chunks and its decode steps (T = 1).  On the card the
    forward kernel from h0 at every T (the final state is its last
    checkpoint), on the CPU the plain version, as the JAX package's
    ``rglru_stateful``.  No gradient.  DTensors run as :func:`rglru`'s;
    the state comes back in h0's layout."""
    if isinstance(x, DTensor):
        pl = _scan_layout(x, x.shape[2], 2)
        hpl = _heads_of(pl, {0: 0, 2: 1})
        h, hT = _scan_sharded(_rglru_stateful_local, (x, a), pl, (h0,),
                              (hpl,), (hpl,), (pl, hpl))
        return h, hT.redistribute(h0.device_mesh, h0.placements)
    if _on_cuda(x):
        h, ck = rglru_scan(x, a, h0=h0.float(), with_state=True)
        return h, ck[:, -1]
    return ref.rglru(x, a, h0)


def _rglru_stateful_local(x, a, h0):
    if x.device.type == "meta":
        return _standin(ref.rglru, (x, a, h0), 2)
    return rglru_stateful(x, a, h0)


def _standin(plain, args: tuple, n_seq: int):
    """The dry run's count of a recurrence on ``meta`` shards
    (``launch.costmodel.scan_standin``), imported where it is used: only
    the dry run makes ``meta`` shards."""
    from ..launch.costmodel import scan_standin
    return scan_standin(plain, args, n_seq)
