"""Plain PyTorch versions of the port's kernels (own copy of the oracles in
``repro.kernels.ref``).  They are the ground truth the CUDA kernels are
held to on the card, and the path a CPU tensor takes through
:mod:`repro_torch.kernels.ops`."""
from __future__ import annotations

import torch


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, H, hd) by repeating each kv head."""
    n_kv = k.shape[-2]
    if n_kv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // n_kv, dim=-2)


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """f32 scores (B, H, Sq, Sk), scaled by hd^-0.5."""
    hd = q.shape[-1]
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd ** -0.5


def _softmax_av(scores: torch.Tensor, v: torch.Tensor,
                out_dtype: torch.dtype) -> torch.Tensor:
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(out_dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """Full-sequence attention with GQA.

    q: (B, S, H, hd);  k, v: (B, S, KV, hd)  ->  (B, S, H, hd).
    window > 0 restricts key positions to (qpos - window, qpos].
    """
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    k = _repeat_kv(k, H)
    v = _repeat_kv(v, H)
    scores = _scores(q, k)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    scores = scores.masked_fill(~mask, float("-inf"))
    return _softmax_av(scores, v, q.dtype)


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, window: int = 0,
                      block_q: int = 1024) -> torch.Tensor:
    """Blockwise attention for long sequences: loop over query chunks so
    the score matrix never exceeds (block_q, S) per batch-head."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    k = _repeat_kv(k, H)
    v = _repeat_kv(v, H)
    bq = min(block_q, Sq)
    if Sq % bq:
        raise ValueError(f"Sq={Sq} is not a multiple of block_q={bq}")
    kpos = torch.arange(Sk, device=q.device)[None, :]
    outs = []
    for qstart in range(0, Sq, bq):
        scores = _scores(q[:, qstart:qstart + bq], k)
        qpos = qstart + torch.arange(bq, device=q.device)[:, None]
        mask = torch.ones((bq, Sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window > 0:
            mask &= kpos > qpos - window
        scores = scores.masked_fill(~mask, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v))
    return torch.cat(outs, dim=1).to(q.dtype)


def attention_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Single-token decode.  q: (B, 1, H, hd); k, v: (B, L, KV, hd);
    valid: (L,) or per-sequence (B, L) bool mask of live cache slots.  At
    least one slot per sequence must be valid."""
    B, _, H, hd = q.shape
    k = _repeat_kv(k, H)
    v = _repeat_kv(v, H)
    scores = _scores(q, k)
    vmask = valid[None, :] if valid.ndim == 1 else valid        # (B, L)
    scores = scores.masked_fill(~vmask.bool()[:, None, None, :],
                                float("-inf"))
    return _softmax_av(scores, v, q.dtype)


def page_gather(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """pool: (P, page, ...); page_table: (B, n_pp) int32 ->
    (B, n_pp * page, ...) — the paged KV cache's logical view."""
    B, n_pp = page_table.shape
    out = pool[page_table.long()]                # (B, n_pp, page, ...)
    return out.reshape((B, n_pp * pool.shape[1]) + tuple(pool.shape[2:]))


def ring_gather(hist: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """hist: (size, ...) stacked versions; idx: 0-d integer tensor ->
    a copy of hist[idx], bit for bit (``hist[idx]`` itself would be a view,
    which the ring's in-place writes would change under the reader)."""
    return torch.index_select(hist, 0, idx.reshape(1).long())[0]
