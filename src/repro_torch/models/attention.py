"""Self- and cross-attention with GQA, sliding windows, RoPE and KV caches
(port of ``repro.models.attention``): the training and prefill forward;
one-token decode against the dense ring cache (``init_kv_cache``,
``attention_decode``: the JAX package's own form) or against the paged
cache; chunked prefill against the paged cache; and the vision model's
tanh-gated cross-attention to the projected media (``xattn``), which keeps
no cache (the media are re-projected at every call, as in JAX).

The softmax path dispatches through :mod:`repro_torch.kernels.ops`, so the
CUDA kernels and their plain versions share one call site.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..device import on_mesh_of, param_for, resolve_device
from ..kernels import ops as kops
from .config import ModelConfig
from .layers import apply_rope, rmsnorm
from .paramlib import P


def attn_specs(cfg: ModelConfig, kind: str,
               stack: tuple[int, ...] = ()) -> dict:
    lead = ("layers",) * len(stack)
    d, hd = cfg.d_model, cfg.hd
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    specs = {
        "wq": P(stack + (d, nq * hd), lead + ("embed", "heads")),
        "wk": P(stack + (d, nkv * hd), lead + ("embed", "kv_heads")),
        "wv": P(stack + (d, nkv * hd), lead + ("embed", "kv_heads")),
        "wo": P(stack + (nq * hd, d), lead + ("heads", "embed")),
    }
    if kind == "xattn":
        specs["gate"] = P(stack + (1,), lead + (None,), init="zeros")
    if cfg.qk_norm:
        specs["q_norm"] = P(stack + (hd,), lead + (None,), init="ones")
        specs["k_norm"] = P(stack + (hd,), lead + (None,), init="ones")
    return specs


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(..., n * hd) -> (..., n, hd).  A DTensor whose flattened heads are
    split over more ranks than there are heads (llama's 8 kv heads on a
    16-way ``model`` axis: 32 columns a rank) is first gathered over those
    mesh dims, so no shard cuts a head."""
    if isinstance(x, DTensor):
        last = Shard(x.ndim - 1)
        ranks = math.prod(x.device_mesh.size(i)
                          for i, p in enumerate(x.placements) if p == last)
        if n % ranks:
            x = x.redistribute(x.device_mesh, [Replicate() if p == last
                                               else p for p in x.placements])
    return x.reshape(x.shape[:-1] + (n, hd))


class _GradAsValue(torch.autograd.Function):
    """Identity on a DTensor whose backward lays the gradient out as the
    value was: the merged heads' gradient comes back split over ``model``
    (from the row-split ``wo``), which the merge's backward cannot cut
    into heads that do not divide the axis (llama4-scout's 40 on 16)."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    out = x.reshape(x.shape[:-2] + (x.shape[-2] * x.shape[-1],))
    return _GradAsValue.apply(out) if isinstance(out, DTensor) else out


def _rope_theta(cfg: ModelConfig, kind: str) -> float:
    if kind == "attn" and cfg.rope_theta_global is not None:
        return cfg.rope_theta_global
    return cfg.rope_theta


def _qkv(params: dict, x: torch.Tensor, cfg: ModelConfig):
    dt = x.dtype
    q = _split_heads(x @ param_for(params["wq"], dt, x), cfg.n_heads, cfg.hd)
    k = _split_heads(x @ param_for(params["wk"], dt, x), cfg.n_kv_heads,
                     cfg.hd)
    v = _split_heads(x @ param_for(params["wv"], dt, x), cfg.n_kv_heads,
                     cfg.hd)
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"])
        k = rmsnorm(k, params["k_norm"])
    return q, k, v


def attention_fwd(params: dict, x: torch.Tensor, cfg: ModelConfig,
                  kind: str, positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal attention.  x: (B, S, d); positions: (B, S).
    Differentiable: on the card the flash kernels' forward and backward."""
    q, k, v = _qkv(params, x, cfg)
    theta = _rope_theta(cfg, kind)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    window = cfg.window if kind in ("local", "swa") else 0
    out = kops.attention(q, k, v, causal=True, window=window)
    return _merge_heads(out) @ param_for(params["wo"], x.dtype, x)


def cross_attention_fwd(params: dict, x: torch.Tensor, media: torch.Tensor,
                        cfg: ModelConfig) -> torch.Tensor:
    """Cross-attention: queries from the text x (B, S, d), keys and values
    from the projected media (B, N, d); no RoPE, no mask.  The output is
    scaled by tanh(gate), taken in f32 and cast to the compute dtype
    (llama-vision's gating; the gate starts at 0)."""
    dt = x.dtype
    q = _split_heads(x @ param_for(params["wq"], dt, x), cfg.n_heads, cfg.hd)
    k = _split_heads(media @ param_for(params["wk"], dt, media),
                     cfg.n_kv_heads, cfg.hd)
    v = _split_heads(media @ param_for(params["wv"], dt, media),
                     cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"])
        k = rmsnorm(k, params["k_norm"])
    out = kops.attention(q, k, v, causal=False, window=0)
    out = _merge_heads(out) @ param_for(params["wo"], dt, x)
    return torch.tanh(params["gate"].float()).to(dt) * out


def _ring_valid(pos: torch.Tensor, L: int, cfg: ModelConfig,
                kind: str) -> torch.Tensor:
    """Live-slot mask of a ring cache: entry at index i holds absolute
    position p with p % L == i, p <= pos, p > pos - L.  pos: scalar -> (L,);
    pos: (B,) -> (B, L).  ``torch.remainder`` is the floor modulo of
    ``jnp.mod``; ``pos - idx`` is negative for the slots ahead of pos."""
    idx = on_mesh_of(torch.arange(L, device=pos.device), pos)
    if pos.ndim:
        pos = pos[:, None]
    abs_pos = pos - torch.remainder(pos - idx, L)
    valid = (abs_pos >= 0) & (abs_pos >= pos - (L - 1))
    if kind in ("local", "swa") and cfg.window:
        valid &= abs_pos > pos - cfg.window
    return valid


def init_kv_cache(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                  stack: tuple[int, ...] = (),
                  device: str | torch.device | None = None) -> dict:
    """The zero dense ring cache of one attention slot: {"k", "v": stack +
    (batch, L, KV, hd)} in the compute dtype on ``device`` (default
    ``cuda``), two tensors (both are written in place).  L is the JAX
    package's ring length: ``cache_len`` for ``attn``, ``min(window or
    cache_len, cache_len)`` for the windowed kinds."""
    L = cache_len if kind == "attn" else min(cfg.window or cache_len,
                                             cache_len)
    shape = stack + (batch, L, cfg.n_kv_heads, cfg.hd)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def kv_cache_axes(kind: str, stack_dims: int = 0) -> dict:
    """Logical axes of ``init_kv_cache``'s leaves (``stack_dims`` leading
    ``layers`` dims), for the sharding rules."""
    lead = ("layers",) * stack_dims
    ax = lead + ("batch", "kv_seq", "kv_heads", None)
    return {"k": ax, "v": ax}


def _ring_write(buf: torch.Tensor, slot: torch.Tensor,
                new: torch.Tensor) -> None:
    """``buf[b, slot[b]] = new[b]`` for every row b, in place: buf (B, L,
    ...), slot (B,), new (B, ...).  A DTensor ring (its rows and slots
    split over the mesh, ``cache_axes``) is written shard by shard: each
    rank writes the rows it holds whose slot falls in its part of the ring
    and writes the others' current values back (DTensor has no in-place
    scatter on a split tensor)."""
    if not isinstance(buf, DTensor):
        rows = torch.arange(buf.shape[0], device=buf.device)
        buf.index_put_((rows, slot), new)
        return
    mesh, pl = buf.device_mesh, buf.placements
    if any(not isinstance(p, (Shard, Replicate)) or
           isinstance(p, Shard) and p.dim > 1 for p in pl):
        raise ValueError(f"ring write: unsupported cache layout {pl}")
    rows_pl = [Shard(0) if p == Shard(0) else Replicate() for p in pl]
    slot = slot.redistribute(mesh, rows_pl).to_local()
    new = new.redistribute(mesh, rows_pl).to_local()
    loc = buf.to_local()
    part, coord = 0, mesh.get_coordinate()
    for i, p in enumerate(pl):
        if p == Shard(1):
            part = part * mesh.size(i) + coord[i]
    Ll = loc.shape[1]
    rel = slot - part * Ll
    inside = (rel >= 0) & (rel < Ll)
    rel = rel.clamp(0, Ll - 1)
    rows = torch.arange(loc.shape[0], device=loc.device)
    keep = inside.reshape((-1,) + (1,) * (new.ndim - 1))
    loc.index_put_((rows, rel), torch.where(keep, new, loc[rows, rel]))


def attention_decode(params: dict, x: torch.Tensor, cache: dict,
                     cfg: ModelConfig, kind: str,
                     pos: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One-token decode against the dense ring cache {"k", "v": (B, L, KV,
    hd)} (``init_kv_cache`` or ``prefill``'s).  x: (B, 1, d); pos: a
    scalar (every row at one position, JAX's ``_dyn_update``) or (B,)
    per-row positions.  The new K/V entry lands at slot ``pos % L`` of
    each row **in place** (``index_put_``, where JAX returns new arrays);
    the returned cache is the same dict.  The read is
    ``kops.attention_decode`` over the ring and ``_ring_valid``'s mask: on
    the card the ``decode_attention`` kernel in its gathered form, on the
    CPU ``ref.attention_decode``.  Returns (out (B, 1, d), cache)."""
    q, k_new, v_new = _qkv(params, x, cfg)
    theta = _rope_theta(cfg, kind)
    B = x.shape[0]
    posb = pos.expand(B) if pos.ndim == 0 else pos
    q = apply_rope(q, posb[:, None], theta)
    k_new = apply_rope(k_new, posb[:, None], theta)

    k, v = cache["k"], cache["v"]
    L = k.shape[1]
    slot = torch.remainder(posb.long(), L)                       # (B,)
    _ring_write(k, slot, k_new[:, 0].to(k.dtype))
    _ring_write(v, slot, v_new[:, 0].to(v.dtype))

    valid = _ring_valid(pos, L, cfg, kind)
    out = kops.attention_decode(q, k, v, valid)
    out = _merge_heads(out) @ param_for(params["wo"], x.dtype, x)
    return out, cache


def attention_decode_paged(params: dict, x: torch.Tensor, cache: dict,
                           cfg: ModelConfig, kind: str,
                           pos: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One-token decode against a paged KV cache
    (:mod:`repro_torch.serve.paged_cache`).

    cache: {"pk", "pv": (P, page, KV, hd) page pools shared by all
    sequence slots, "pt": (B, n_pp) int32 page table}.  pos: (B,)
    per-sequence positions (idle slots sit at pos 0 with their tables on
    the junk page, so their write lands there).  The new K/V entry is
    written into the pools **in place** (``index_put_``); the returned
    cache is the same dict.  Idle rows all write pos 0 of the junk page:
    duplicate indices there are harmless, and what an idle row reads back
    from it is discarded.  The ring is then read through the page table in
    place (on the card one kernel reads the pools, on the CPU
    ``page_gather`` copies them), after the write on the same stream.
    """
    q, k_new, v_new = _qkv(params, x, cfg)
    theta = _rope_theta(cfg, kind)
    B = x.shape[0]
    posb = pos.expand(B) if pos.ndim == 0 else pos
    q = apply_rope(q, posb[:, None], theta)
    k_new = apply_rope(k_new, posb[:, None], theta)

    pk, pv, pt = cache["pk"], cache["pv"], cache["pt"]
    page = pk.shape[1]
    L = pt.shape[1] * page
    slot = torch.remainder(posb.long(), L)                       # (B,)
    phys = torch.gather(pt, 1, (slot // page)[:, None])[:, 0].long()
    off = slot % page
    pk.index_put_((phys, off), k_new[:, 0].to(pk.dtype))
    pv.index_put_((phys, off), v_new[:, 0].to(pv.dtype))

    valid = _ring_valid(posb, L, cfg, kind)
    out = kops.attention_decode_paged(q, pk, pv, pt, valid)
    out = _merge_heads(out) @ param_for(params["wo"], x.dtype, x)
    return out, cache


def ring_positions(start: int, L: int, device) -> torch.Tensor:
    """Absolute position held by each slot of an L-slot ring just before
    position ``start`` lands: the newest prior entry is start-1 and slot i
    holds last - (last-i) % L; slots never written come out -1 (dead).
    ``torch.remainder`` is the floor modulo of ``jnp.mod``, so at start 0
    every slot is dead.  Returns (L,) int32."""
    idx = torch.arange(L, device=device, dtype=torch.int32)
    last = start - 1
    abs_pos = last - torch.remainder(last - idx, L)
    return torch.where(abs_pos >= 0, abs_pos, -1)


def chunk_positions(start: int, C: int, pt: torch.Tensor,
                    page: int) -> dict:
    """Positions and scatter targets of a chunk at start..start+C-1 over
    the ring behind page-table row ``pt`` (1, n_pp): ``q_pos`` (1, C) and
    ``ctx_pos`` (1, L) int32, and the pool coordinates (``phys``, ``off``)
    of the chunk's own slots.  Every layer of one page class shares them,
    so ``prefill_chunk`` makes them once per chunk and class."""
    dev = pt.device
    L = pt.shape[1] * page
    q_pos = (start + torch.arange(C, device=dev, dtype=torch.int32))[None]
    slot = torch.remainder(q_pos[0].long(), L)                  # (C,)
    return {"q_pos": q_pos, "ctx_pos": ring_positions(start, L, dev)[None],
            "phys": pt[0, slot // page].long(), "off": slot % page}


def attention_prefill_paged(params: dict, x: torch.Tensor, cache: dict,
                            cfg: ModelConfig, kind: str, start: int,
                            pos: dict | None = None
                            ) -> tuple[torch.Tensor, dict]:
    """One prompt chunk against a paged KV cache (chunked prefill).

    x: (1, C, d) — chunk tokens at absolute positions start..start+C-1;
    cache: {"pk", "pv": (P, page, KV, hd) pools, "pt": (1, n_pp) page-table
    row of the slot being prefilled}; pos: ``chunk_positions`` of this
    chunk and row, made here when not given.  Prior chunks' K/V are read
    through the page table in place (on the card one kernel reads the
    pools, on the CPU ``page_gather`` copies them), *before* the chunk's
    own K/V are scattered in: the scatter follows on the same stream, so a
    windowed ring that wraps within this chunk still sees the pre-wrap
    entries it legitimately covers.  Keys are masked by absolute position
    exactly like a full-sequence causal prefill.  C must not exceed the ring length L (the serve engine caps
    the chunk at the smallest page-class L so scatter slots are unique).
    The chunk's K/V are written into the pools in place; returns
    (out (1, C, d), cache).
    """
    pk, pv, pt = cache["pk"], cache["pv"], cache["pt"]
    if pos is None:
        pos = chunk_positions(start, x.shape[1], pt, pk.shape[1])
    q, k_new, v_new = _qkv(params, x, cfg)
    theta = _rope_theta(cfg, kind)
    q_pos = pos["q_pos"]
    q = apply_rope(q, q_pos, theta)
    k_new = apply_rope(k_new, q_pos, theta)

    window = cfg.window if kind in ("local", "swa") else 0
    out = kops.prefill_page_attention_paged(q, pk, pv, pt, k_new, v_new,
                                            pos["ctx_pos"], q_pos,
                                            window=window)

    pk.index_put_((pos["phys"], pos["off"]), k_new[0].to(pk.dtype))
    pv.index_put_((pos["phys"], pos["off"]), v_new[0].to(pv.dtype))
    out = _merge_heads(out) @ param_for(params["wo"], x.dtype, x)
    return out, cache
