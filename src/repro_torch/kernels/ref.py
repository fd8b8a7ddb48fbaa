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


def prefill_mask(ctx_pos: torch.Tensor, q_pos: torch.Tensor,
                 window: int = 0) -> torch.Tensor:
    """(B, C, L + C) bool: which keys (context slots, then the chunk's
    own) each chunk row sees — ``0 <= kpos <= qpos``, and
    ``kpos > qpos - window`` when window > 0."""
    kpos = torch.cat([ctx_pos, q_pos], dim=1)[:, None, :]   # (B, 1, L + C)
    qp = q_pos[:, :, None]                                  # (B, C, 1)
    mask = (kpos >= 0) & (kpos <= qp)
    if window > 0:
        mask &= kpos > qp - window
    return mask


def prefill_page_attention(q: torch.Tensor, k_ctx: torch.Tensor,
                           v_ctx: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, ctx_pos: torch.Tensor,
                           q_pos: torch.Tensor,
                           window: int = 0) -> torch.Tensor:
    """Chunked-prefill attention against a gathered ring/paged context.

    q, k_new, v_new: (B, C, H|KV, hd) — the current prompt chunk (RoPE'd);
    k_ctx, v_ctx: (B, L, KV, hd) — the logical ring view of prior chunks'
    pages (page_gather output); ctx_pos: (B, L) int32 absolute position
    held by each ring slot, negative = dead slot; q_pos: (B, C) int32
    absolute positions of the chunk tokens.  Keys are masked to
    ``0 <= kpos <= qpos`` (and ``kpos > qpos - window`` when window > 0),
    so a chunk starting mid-sequence attends to exactly the prefix it
    would see in a full-sequence prefill.  Returns (B, C, H, hd).
    """
    H = q.shape[2]
    k = _repeat_kv(torch.cat([k_ctx, k_new.to(k_ctx.dtype)], dim=1), H)
    v = _repeat_kv(torch.cat([v_ctx, v_new.to(v_ctx.dtype)], dim=1), H)
    mask = prefill_mask(ctx_pos, q_pos, window)
    scores = _scores(q, k).masked_fill(~mask[:, None], float("-inf"))
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


def moe_grouped_ffn(dispatch: torch.Tensor, combine: torch.Tensor,
                    xg: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                    wd: torch.Tensor, ep=None) -> torch.Tensor:
    """Dense one-hot MoE dispatch (GShard style).

    dispatch: (G, g, E, C) bool; combine: (G, g, E, C) f32; xg: (G, g, d);
    wg/wu: (E, d, f); wd: (E, f, d) -> (G, g, d) in xg's dtype.  The
    combine weights are rounded to xg's dtype before the last product, as
    the JAX package's plain version does.  ``ep`` optionally lays the
    dispatched intermediates out (models/moe.py).
    """
    if ep is None:
        ep = lambda t: t  # noqa: E731
    xin = ep(torch.einsum("GgEC,Ggd->EGCd", dispatch.to(xg.dtype), xg))
    h = torch.nn.functional.silu(torch.einsum("EGCd,Edf->EGCf", xin, wg))
    u = torch.einsum("EGCd,Edf->EGCf", xin, wu)
    out_e = ep(torch.einsum("EGCf,Efd->EGCd", h * u, wd))
    return torch.einsum("GgEC,EGCd->Ggd", combine.to(xg.dtype), out_e)


def rwkv6_stateful(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, S0: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 WKV recurrence (Finch, arXiv:2404.05892) from the state S0.

    r, k, v, w: (B, T, H, hd) with w in (0, 1) the data-dependent decay;
    u: (H, hd) the current-token bonus; S0: (B, H, hd, hd).  In f32:

        y_t[j] = sum_i r_t[i] * (S_t[i,j] + u[i] k_t[i] v_t[j])
        S_{t+1}[i,j] = w_t[i] S_t[i,j] + k_t[i] v_t[j]

    Returns (y (B, T, H, hd) in r's dtype, the final state (B, H, hd, hd)
    in f32).
    """
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()
    S = S0.float()
    ys = []
    for t in range(r.shape[1]):
        r_t, k_t, v_t, w_t = rf[:, t], kf[:, t], vf[:, t], wf[:, t]
        y = torch.einsum("bhi,bhij->bhj", r_t, S)
        bonus = torch.einsum("bhi,bhi->bh", r_t, uf[None] * k_t)
        ys.append(y + bonus[..., None] * v_t)
        S = S * w_t[..., :, None] + k_t[..., :, None] * v_t[..., None, :]
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(rf)
    return y.to(r.dtype), S


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The WKV recurrence of ``rwkv6_stateful`` from a zero state:
    (B, T, H, hd) -> (B, T, H, hd) in r's dtype."""
    B, _, H, hd = r.shape
    S0 = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
    return rwkv6_stateful(r, k, v, w, u, S0)[0]


def rglru(x: torch.Tensor, a: torch.Tensor,
          h0: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """RG-LRU linear recurrence (Griffin, arXiv:2402.19427).

    x: (B, T, D) gated input (i_t * x_t); a: (B, T, D) decay in (0, 1).
        h_t = a_t * h_{t-1} + sqrt(clip(1 - a_t^2, 0, 1)) * x_t
    in f32 from h0 (B, D) or zero.  Returns (h (B, T, D) in x's dtype, the
    final state (B, D) in f32).
    """
    B, T, D = x.shape
    xf, af = x.float(), a.float()
    gate = torch.sqrt(torch.clamp(1.0 - af * af, 0.0, 1.0))
    h = (torch.zeros((B, D), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    hs = []
    for t in range(T):
        h = af[:, t] * h + gate[:, t] * xf[:, t]
        hs.append(h)
    out = torch.stack(hs, dim=1) if hs else torch.zeros_like(xf)
    return out.to(x.dtype), h
