"""RWKV-6 (Finch) block: token-shift time mix with the data-dependent decay
WKV, plus the squared-ReLU channel mix (port of ``repro.models.rwkv6``,
arXiv:2404.05892).

As in the JAX package: the decay w_t = exp(-exp(base + LoRA(x_t))) keeps
its data dependence, the token-shift mixing coefficients are static per
channel (RWKV-5 style), the output is a per-head group norm, silu-gated.
The full-sequence forward goes through ``ops.rwkv6`` (the CUDA kernels on
the card, autograd of the plain version on the CPU).  The stateful decode
path (``time_mix_decode``, ``init_rwkv_state``) comes with rwkv6 serving.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from .config import ModelConfig
from .layers import rmsnorm
from .paramlib import P


def rwkv6_specs(cfg: ModelConfig, stack: tuple[int, ...] = ()) -> dict:
    lead = ("layers",) * len(stack)
    d = cfg.d_model
    H, hd = cfg.n_heads, cfg.hd
    r_lo = cfg.decay_lora
    tm = {
        # token-shift mix coefficients (static lerp weights in [0,1] via
        # sigmoid at apply time)
        "mu_r": P(stack + (d,), lead + (None,), init="zeros"),
        "mu_k": P(stack + (d,), lead + (None,), init="zeros"),
        "mu_v": P(stack + (d,), lead + (None,), init="zeros"),
        "mu_w": P(stack + (d,), lead + (None,), init="zeros"),
        "mu_g": P(stack + (d,), lead + (None,), init="zeros"),
        "wr": P(stack + (d, H * hd), lead + ("embed", "heads")),
        "wk": P(stack + (d, H * hd), lead + ("embed", "heads")),
        "wv": P(stack + (d, H * hd), lead + ("embed", "heads")),
        "wg": P(stack + (d, H * hd), lead + ("embed", "heads")),
        "wo": P(stack + (H * hd, d), lead + ("heads", "embed")),
        # data-dependent decay: w_t = exp(-exp(decay_base + x W1 W2))
        "decay_base": P(stack + (H, hd), lead + (None, None), init="zeros"),
        "decay_w1": P(stack + (d, r_lo), lead + ("embed", None), scale=0.01),
        "decay_w2": P(stack + (r_lo, H * hd), lead + (None, "heads"),
                      scale=0.01),
        "bonus_u": P(stack + (H, hd), lead + (None, None), scale=0.1),
        "gn_scale": P(stack + (H, hd), lead + (None, None), init="ones"),
    }
    cm = {
        "mu_ck": P(stack + (d,), lead + (None,), init="zeros"),
        "mu_cr": P(stack + (d,), lead + (None,), init="zeros"),
        "ck": P(stack + (d, cfg.d_ff), lead + ("embed", "ffn")),
        "cv": P(stack + (cfg.d_ff, d), lead + ("ffn", "embed")),
        "cr": P(stack + (d, d), lead + ("embed", "embed2")),
    }
    return {"time": tm, "chan": cm}


def _token_shift(x: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """lerp(x_t, x_{t-1}, sigmoid(mu)) with x_{-1} = 0.  x: (B, T, d).
    (The JAX version also takes the previous chunk's last token, for
    decode; that carry comes with rwkv6 serving.)"""
    prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    m = torch.sigmoid(mu.float()).to(x.dtype)
    return x + m * (prev - x)


def _time_mix_inputs(tp: dict, x: torch.Tensor, cfg: ModelConfig):
    """r, k, v, g (B, T, H, hd) in the compute dtype; the decay w in f32."""
    B, T, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    dt = x.dtype

    def proj(mu, w):
        return (_token_shift(x, mu) @ w.to(dt)).reshape(B, T, H, hd)

    r = proj(tp["mu_r"], tp["wr"])
    k = proj(tp["mu_k"], tp["wk"])
    v = proj(tp["mu_v"], tp["wv"])
    g = proj(tp["mu_g"], tp["wg"])
    xw = _token_shift(x, tp["mu_w"])
    dlo = (xw @ tp["decay_w1"].to(dt)) @ tp["decay_w2"].to(dt)
    dlog = tp["decay_base"].float()[None, None] \
        + dlo.reshape(B, T, H, hd).float()
    w = torch.exp(-torch.exp(dlog))                      # decay in (0,1)
    return r, k, v, g, w


def _finish(tp: dict, y: torch.Tensor, g: torch.Tensor,
            x_dtype: torch.dtype) -> torch.Tensor:
    B, T, H, hd = y.shape
    y = rmsnorm(y, tp["gn_scale"])                       # per-head group norm
    y = y * F.silu(g.float()).to(y.dtype)
    return y.reshape(B, T, H * hd).to(x_dtype) @ tp["wo"].to(x_dtype)


def time_mix_fwd(tp: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    r, k, v, g, w = _time_mix_inputs(tp, x, cfg)
    y = kops.rwkv6(r, k, v, w, tp["bonus_u"])
    return _finish(tp, y, g, x.dtype)


def chan_mix_fwd(cp: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    xk = _token_shift(x, cp["mu_ck"])
    xr = _token_shift(x, cp["mu_cr"])
    kk = torch.square(F.relu(xk @ cp["ck"].to(dt)))
    return torch.sigmoid((xr @ cp["cr"].to(dt)).float()).to(dt) \
        * (kk @ cp["cv"].to(dt))
