"""RWKV-6 (Finch) block: token-shift time mix with the data-dependent decay
WKV, plus the squared-ReLU channel mix (port of ``repro.models.rwkv6``,
arXiv:2404.05892).

As in the JAX package: the decay w_t = exp(-exp(base + LoRA(x_t))) keeps
its data dependence, the token-shift mixing coefficients are static per
channel (RWKV-5 style), the output is a per-head group norm, silu-gated.
The full-sequence forward goes through ``ops.rwkv6`` (the CUDA kernels on
the card, autograd of the plain version on the CPU).  Serving carries a
state per sequence (``init_rwkv_state``: the f32 WKV state and the last
token of each token shift): ``time_mix_decode`` and ``chan_mix_fwd(...,
x_last=)`` run a prompt (from the zero state), a prompt chunk or a decode
step from it, the WKV through ``ops.rwkv6_stateful`` (the forward kernel
from the carried state on the card).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import param_for
from ..kernels import ops as kops
from .attention import _split_heads
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


def _token_shift(x: torch.Tensor, x_prev_last: torch.Tensor | None,
                 mu: torch.Tensor) -> torch.Tensor:
    """lerp(x_t, x_{t-1}, sigmoid(mu)).  x: (B, T, d); x_prev_last: (B, d)
    the previous chunk's last token (decode, a prompt chunk), or None for
    x_{-1} = 0.  The shift is a concatenation (a zero row or the carry,
    then x's first T - 1 rows), which DTensor propagates on every torch
    version (a pad it does not)."""
    first = (torch.zeros_like(x[:, :1]) if x_prev_last is None
             else x_prev_last[:, None].to(x.dtype))
    prev = torch.cat([first, x[:, :-1]], dim=1)
    m = torch.sigmoid(mu.float()).to(x.dtype)
    return x + m * (prev - x)


def _time_mix_inputs(tp: dict, x: torch.Tensor, cfg: ModelConfig,
                     x_last: torch.Tensor | None = None):
    """r, k, v, g (B, T, H, hd) in the compute dtype; the decay w in f32.
    ``x_last``: the token shifts' carry (``_token_shift``)."""
    B, T, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    dt = x.dtype

    def proj(mu, w):
        return _split_heads(_token_shift(x, x_last, mu)
                            @ param_for(w, dt, x), H, hd)

    r = proj(tp["mu_r"], tp["wr"])
    k = proj(tp["mu_k"], tp["wk"])
    v = proj(tp["mu_v"], tp["wv"])
    g = proj(tp["mu_g"], tp["wg"])
    xw = _token_shift(x, x_last, tp["mu_w"])
    dlo = xw @ param_for(tp["decay_w1"], dt, xw)
    dlo = dlo @ param_for(tp["decay_w2"], dt, dlo)
    dlog = tp["decay_base"].float()[None, None] \
        + _split_heads(dlo, H, hd).float()
    w = torch.exp(-torch.exp(dlog))                      # decay in (0,1)
    return r, k, v, g, w


def _finish(tp: dict, y: torch.Tensor, g: torch.Tensor,
            x_dtype: torch.dtype) -> torch.Tensor:
    B, T, H, hd = y.shape
    y = rmsnorm(y, tp["gn_scale"])                       # per-head group norm
    y = y * F.silu(g.float()).to(y.dtype)
    y = y.reshape(B, T, H * hd).to(x_dtype)
    return y @ param_for(tp["wo"], x_dtype, y)


def time_mix_fwd(tp: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    r, k, v, g, w = _time_mix_inputs(tp, x, cfg)
    y = kops.rwkv6(r, k, v, w, tp["bonus_u"])
    return _finish(tp, y, g, x.dtype)


def time_mix_decode(tp: dict, x: torch.Tensor, state: dict,
                    cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """The time mix from a carried state.  x: (B, T, d) (T = 1 a decode
    step, T > 1 a prompt or a chunk); state: {"S": (B, H, hd, hd) f32,
    "x_last": (B, d)}.  Returns (out (B, T, d), {"S": the final state,
    "x_last": x's last token})."""
    r, k, v, g, w = _time_mix_inputs(tp, x, cfg, state["x_last"])
    y, S1 = kops.rwkv6_stateful(r, k, v, w, tp["bonus_u"], state["S"])
    out = _finish(tp, y, g, x.dtype)
    return out, {"S": S1, "x_last": x[:, -1]}


def chan_mix_fwd(cp: dict, x: torch.Tensor, cfg: ModelConfig,
                 x_last: torch.Tensor | None = None) -> torch.Tensor:
    """The squared-ReLU channel mix; ``x_last`` (B, d): the token shifts'
    carry from the previous chunk, or None for zero."""
    dt = x.dtype
    xk = _token_shift(x, x_last, cp["mu_ck"])
    xr = _token_shift(x, x_last, cp["mu_cr"])
    kk = torch.square(F.relu(xk @ param_for(cp["ck"], dt, x)))
    return torch.sigmoid((xr @ param_for(cp["cr"], dt, x)).float()).to(dt) \
        * (kk @ param_for(cp["cv"], dt, x))


def rwkv_state_axes(stack_dims: int = 0) -> dict:
    """Logical axes of ``init_rwkv_state``'s leaves."""
    lead = ("layers",) * stack_dims
    return {"S": lead + ("batch", "heads_act", None, None),
            "x_last": lead + ("batch", None),
            "cx_last": lead + ("batch", None)}


def init_rwkv_state(cfg: ModelConfig, batch: int,
                    stack: tuple[int, ...] = (),
                    device: str | torch.device = "cpu") -> dict:
    """Zero serving state: {"S": stack + (batch, H, hd, hd) f32, "x_last",
    "cx_last": stack + (batch, d) in the compute dtype}."""
    H, hd, d = cfg.n_heads, cfg.hd, cfg.d_model
    return {"S": torch.zeros(stack + (batch, H, hd, hd), dtype=torch.float32,
                             device=device),
            "x_last": torch.zeros(stack + (batch, d), dtype=cfg.dtype,
                                  device=device),
            "cx_last": torch.zeros(stack + (batch, d), dtype=cfg.dtype,
                                   device=device)}
