"""Shared neural building blocks: norms, RoPE, embeddings, gated MLPs
(port of ``repro.models.layers``).

All forwards take an explicit params dict, compute norms and softmaxes in
float32, and return activations in the model compute dtype.  Parameters
are cast per use (``params["wq"].to(dt)``) exactly where the JAX package
casts them, so an f32 master tree and a serving copy in ``cfg.dtype``
give the same results.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .paramlib import P


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_specs(cfg: ModelConfig, stack: tuple[int, ...] = ()) -> dict:
    """Parameter specs for one norm layer (possibly stacked)."""
    lead_axes = ("layers",) * len(stack)
    if cfg.norm == "layernorm_np":      # olmo: non-parametric — no params
        return {}
    d = {"scale": P(stack + (cfg.d_model,), lead_axes + (None,), init="ones")}
    if cfg.norm == "layernorm":
        d["bias"] = P(stack + (cfg.d_model,), lead_axes + (None,), init="zeros")
    return d


def apply_norm(params: dict, x: torch.Tensor, cfg: ModelConfig,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "rmsnorm":
        out = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        if params:
            out = out * params["scale"].float()
        return out.to(x.dtype)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mean) * torch.rsqrt(var + eps)
    if cfg.norm == "layernorm":
        out = out * params["scale"].float() + params["bias"].float()
    return out.to(x.dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor | None = None,
            eps: float = 1e-6) -> torch.Tensor:
    """Standalone rmsnorm (qk-norm) in f32."""
    xf = x.float()
    out = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    if scale is not None:
        out = out * scale.float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device | None = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Split-half RoPE with f32 angles.  x: (..., seq, heads, head_dim);
    positions: (..., seq)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)             # (hd/2,)
    angles = positions[..., :, None].float() * freqs          # (.., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]                  # (.., S, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ModelConfig, stack: tuple[int, ...] = ()) -> dict:
    lead = ("layers",) * len(stack)
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp in ("swiglu", "geglu"):
        return {
            "wg": P(stack + (d, f), lead + ("embed", "ffn")),
            "wu": P(stack + (d, f), lead + ("embed", "ffn")),
            "wd": P(stack + (f, d), lead + ("ffn", "embed")),
        }
    return {  # plain gelu MLP
        "wu": P(stack + (d, f), lead + ("embed", "ffn")),
        "wd": P(stack + (f, d), lead + ("ffn", "embed")),
    }


def apply_mlp(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    if cfg.mlp in ("swiglu", "geglu"):
        gate = x @ params["wg"].to(dt)
        g = F.silu(gate) if cfg.mlp == "swiglu" else \
            F.gelu(gate, approximate="tanh")
        u = x @ params["wu"].to(dt)
        return (g * u) @ params["wd"].to(dt)
    h = F.gelu(x @ params["wu"].to(dt), approximate="tanh")
    return h @ params["wd"].to(dt)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def embed_specs(cfg: ModelConfig) -> dict:
    specs = {"embedding": P((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                            scale=0.02)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = P((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return specs


def embed_tokens(params: dict, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    x = params["embedding"].to(cfg.dtype)[tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype)
    return x


def lm_logits(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        w = params["embedding"].to(cfg.dtype).T
    else:
        w = params["lm_head"].to(cfg.dtype)
    logits = x @ w
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        return torch.tanh(logits.float() / c) * c
    return logits.float()
