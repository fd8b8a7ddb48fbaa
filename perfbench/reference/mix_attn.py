"""Causal self-attention: q, k, v projections, split-half rotary
embeddings at positions 0..S-1, causal softmax(q k^T / sqrt(hd)) v over
grouped key/value heads, keys limited to the last ``window`` positions
where the layer kind is windowed (``local``, ``swa``), output
projection."""
import math

import torch


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotary embedding of x (B, S, H, hd) at positions
    0..S-1."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def apply(p: dict, x: torch.Tensor, cfg: dict, kind: str, nm
          ) -> torch.Tensor:
    B, S, _ = x.shape
    H, KV, hd = cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg)
    q = nm.mm(x, p["wq"]).view(B, S, H, hd)
    k = nm.mm(x, p["wk"]).view(B, S, KV, hd)
    v = nm.mm(x, p["wv"]).view(B, S, KV, hd)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    k = k.repeat_interleave(H // KV, dim=2)
    v = v.repeat_interleave(H // KV, dim=2)
    s = nm.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    qp = torch.arange(S, device=x.device)[:, None]
    kp = torch.arange(S, device=x.device)[None, :]
    live = kp <= qp
    if kind in ("local", "swa") and cfg["window"] > 0:
        live = live & (kp > qp - cfg["window"])
    s = s.masked_fill(~live, float("-inf"))
    o = nm.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    return nm.mm(o.reshape(B, S, H * hd), p["wo"])
