"""RWKV-6 (Finch) block: token-shift time mix with the data-dependent decay
WKV, plus the squared-ReLU channel mix (port of ``repro.models.rwkv6``,
arXiv:2404.05892).

Two forms, chosen by ``ModelConfig.mix_lora`` alone:

* ``mix_lora == 0``, the JAX package's block (bit for bit its port): the
  decay w_t = exp(-exp(base + x_w W1 W2)) keeps its data dependence, but
  the token shifts mix x_t and x_{t-1} by a static per-channel
  ``sigmoid(mu)`` (RWKV-5 style), the decay LoRA has no tanh, and the
  output norm is a per-head RMS norm with a scale only.  These are the
  departures from the paper.
* ``mix_lora > 0``, Finch as published (§4; RWKV-LM's ``RWKV_Tmix_x060``
  and ``RWKV_CMix_x060``): the data-dependent token shift
  ``ddlerp_c(a, b) = a + (b - a) * (mu_c + tanh((a + (b - a) * maa_x)
  A) B_c)`` for c in (w, k, v, r, g), one shared A (d, 5 mix_lora) and
  five B_c (mix_lora, d) stacked in that order; the decay
  ``base + tanh(x_w W1) W2``; a GroupNorm per head (mean-centred, scale
  and bias, eps 1e-5 * 8^2); and static coefficients taken as they are,
  ``x + (x_{t-1} - x) * mu``, in both mixes.

The full-sequence forward goes through ``ops.rwkv6`` (the CUDA kernels on
the card, autograd of the plain version on the CPU), inside a
``model.wkv`` span.  Serving carries a state per sequence
(``init_rwkv_state``: the f32 WKV state and the last token of each token
shift): ``time_mix_decode`` and ``chan_mix_fwd(..., x_last=)`` run a
prompt (from the zero state), a prompt chunk or a decode step from it,
the WKV through ``ops.rwkv6_stateful`` (the forward kernel from the
carried state on the card); both forms take their shifts from the carry
through the same code.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..device import param_for
from ..kernels import ops as kops
from ..trace import span
from .attention import _split_heads
from .config import ModelConfig
from .layers import rmsnorm
from .paramlib import P

MIX_ORDER = "wkvrg"               # Finch's five ddlerp targets, B's order
GN_EPS = 1e-5 * 8 ** 2            # Finch's ln_x: 1e-5 x head_size_divisor^2
MU_SCALE = 0.5                    # Finch's static coefficients: a normal draw
# Finch's key, gate and output products start at a tenth of the fan-in
# scale, as RWKV-LM starts its key and gate (its output at zero, which
# would leave every other leaf of the block without a gradient at step 1);
# at the fan-in scale 24 layers amplify a rounding of the weights thousands
# of times in the gradients
SMALL_GAIN = 0.1


def rwkv6_specs(cfg: ModelConfig, stack: tuple[int, ...] = ()) -> dict:
    """The time mix's and the channel mix's leaves.  The Finch form
    (``mix_lora > 0``) adds ``maa_x``, the shared LoRA factor ``maa_w1``
    (d, 5 mix_lora), the five ``maa_w2`` (5, mix_lora, d) and the group
    norm's ``gn_bias``, draws its static coefficients (zeros in the JAX
    form, whose sigmoid makes them 1/2) from N(0, ``MU_SCALE``^2) and its
    key, gate and output products at ``SMALL_GAIN`` of the fan-in scale;
    no LoRA factor starts at zero, so every leaf has a gradient at step
    1."""
    lead = ("layers",) * len(stack)
    d = cfg.d_model
    H, hd = cfg.n_heads, cfg.hd
    r_lo = cfg.decay_lora
    mu = dict(scale=MU_SCALE) if cfg.mix_lora else dict(init="zeros")

    def small(fan_in: int) -> dict:
        return (dict(scale=SMALL_GAIN / math.sqrt(fan_in)) if cfg.mix_lora
                else {})

    tm = {
        # token-shift mix coefficients (static lerp weights: sigmoid(mu)
        # in the JAX form, mu itself in Finch's)
        "mu_r": P(stack + (d,), lead + (None,), **mu),
        "mu_k": P(stack + (d,), lead + (None,), **mu),
        "mu_v": P(stack + (d,), lead + (None,), **mu),
        "mu_w": P(stack + (d,), lead + (None,), **mu),
        "mu_g": P(stack + (d,), lead + (None,), **mu),
        "wr": P(stack + (d, H * hd), lead + ("embed", "heads")),
        "wk": P(stack + (d, H * hd), lead + ("embed", "heads"), **small(d)),
        "wv": P(stack + (d, H * hd), lead + ("embed", "heads")),
        "wg": P(stack + (d, H * hd), lead + ("embed", "heads"), **small(d)),
        "wo": P(stack + (H * hd, d), lead + ("heads", "embed"),
                **small(H * hd)),
        # data-dependent decay: w_t = exp(-exp(decay_base + x W1 W2)),
        # Finch's with a tanh after W1
        "decay_base": P(stack + (H, hd), lead + (None, None), init="zeros"),
        "decay_w1": P(stack + (d, r_lo), lead + ("embed", None), scale=0.01),
        "decay_w2": P(stack + (r_lo, H * hd), lead + (None, "heads"),
                      scale=0.01),
        "bonus_u": P(stack + (H, hd), lead + (None, None), scale=0.1),
        "gn_scale": P(stack + (H, hd), lead + (None, None), init="ones"),
    }
    if cfg.mix_lora:
        m = cfg.mix_lora
        tm.update({
            "maa_x": P(stack + (d,), lead + (None,), **mu),
            "maa_w1": P(stack + (d, len(MIX_ORDER) * m),
                        lead + ("embed", None), scale=0.01),
            "maa_w2": P(stack + (len(MIX_ORDER), m, d),
                        lead + (None, None, "embed"), scale=0.1),
            "gn_bias": P(stack + (H, hd), lead + (None, None),
                         init="zeros"),
        })
    cm = {
        "mu_ck": P(stack + (d,), lead + (None,), **mu),
        "mu_cr": P(stack + (d,), lead + (None,), **mu),
        "ck": P(stack + (d, cfg.d_ff), lead + ("embed", "ffn")),
        "cv": P(stack + (cfg.d_ff, d), lead + ("ffn", "embed")),
        "cr": P(stack + (d, d), lead + ("embed", "embed2")),
    }
    return {"time": tm, "chan": cm}


def _shifted(x: torch.Tensor, x_prev_last: torch.Tensor | None
             ) -> torch.Tensor:
    """x_{t-1} for every t.  x: (B, T, d); x_prev_last: (B, d) the previous
    chunk's last token (decode, a prompt chunk), or None for x_{-1} = 0.
    The shift is a concatenation (a zero row or the carry, then x's first
    T - 1 rows), which DTensor propagates on every torch version (a pad it
    does not)."""
    first = (torch.zeros_like(x[:, :1]) if x_prev_last is None
             else x_prev_last[:, None].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def _token_shift(x: torch.Tensor, x_prev_last: torch.Tensor | None,
                 mu: torch.Tensor) -> torch.Tensor:
    """The JAX form's lerp(x_t, x_{t-1}, sigmoid(mu))."""
    prev = _shifted(x, x_prev_last)
    m = torch.sigmoid(mu.float()).to(x.dtype)
    return x + m * (prev - x)


def _ddlerp(tp: dict, x: torch.Tensor, x_prev_last: torch.Tensor | None,
            cfg: ModelConfig) -> dict:
    """Finch's data-dependent token shift: {c: x + (x_{t-1} - x) * (mu_c +
    tanh((x + (x_{t-1} - x) * maa_x) A) B_c)} for c in ``MIX_ORDER``, the
    five B_c as one batched product."""
    B, T, d = x.shape
    dt = x.dtype
    dx = _shifted(x, x_prev_last) - x
    xxx = x + dx * tp["maa_x"].to(dt)
    lo = torch.tanh(xxx @ param_for(tp["maa_w1"], dt, xxx))
    lo = lo.view(B * T, len(MIX_ORDER), cfg.mix_lora).transpose(0, 1)
    m = torch.bmm(lo, param_for(tp["maa_w2"], dt, lo))
    m = m.view(len(MIX_ORDER), B, T, d)
    return {c: x + dx * (tp[f"mu_{c}"].to(dt) + m[i])
            for i, c in enumerate(MIX_ORDER)}


def _time_mix_inputs(tp: dict, x: torch.Tensor, cfg: ModelConfig,
                     x_last: torch.Tensor | None = None):
    """r, k, v, g (B, T, H, hd) in the compute dtype; the decay w in f32.
    ``x_last``: the token shifts' carry (``_shifted``)."""
    H, hd = cfg.n_heads, cfg.hd
    dt = x.dtype
    if cfg.mix_lora:
        shifted = _ddlerp(tp, x, x_last, cfg).__getitem__
    else:
        def shifted(c):
            return _token_shift(x, x_last, tp[f"mu_{c}"])

    def proj(c):
        return _split_heads(shifted(c) @ param_for(tp[f"w{c}"], dt, x), H,
                            hd)

    # in this order, the JAX form's gradients add up as they always did
    r, k, v, g = proj("r"), proj("k"), proj("v"), proj("g")
    xw = shifted("w")
    dlo = xw @ param_for(tp["decay_w1"], dt, xw)
    if cfg.mix_lora:
        dlo = torch.tanh(dlo)
    dlo = dlo @ param_for(tp["decay_w2"], dt, dlo)
    dlog = tp["decay_base"].float()[None, None] \
        + _split_heads(dlo, H, hd).float()
    w = torch.exp(-torch.exp(dlog))                      # decay in (0,1)
    return r, k, v, g, w


def _group_norm(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float = GN_EPS) -> torch.Tensor:
    """Finch's ``ln_x``: each head's channels centred and scaled to unit
    variance, then scale and bias per channel; in f32."""
    yf = y.float()
    mean = torch.mean(yf, dim=-1, keepdim=True)
    var = torch.var(yf, dim=-1, keepdim=True, unbiased=False)
    out = (yf - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return out.to(y.dtype)


def _finish(tp: dict, y: torch.Tensor, g: torch.Tensor,
            x_dtype: torch.dtype, cfg: ModelConfig) -> torch.Tensor:
    B, T, H, hd = y.shape
    if cfg.mix_lora:
        y = _group_norm(y, tp["gn_scale"], tp["gn_bias"])
    else:
        y = rmsnorm(y, tp["gn_scale"])                   # per-head norm
    y = y * F.silu(g.float()).to(y.dtype)
    y = y.reshape(B, T, H * hd).to(x_dtype)
    return y @ param_for(tp["wo"], x_dtype, y)


def time_mix_fwd(tp: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    r, k, v, g, w = _time_mix_inputs(tp, x, cfg)
    with span("model.wkv"):
        y = kops.rwkv6(r, k, v, w, tp["bonus_u"])
    return _finish(tp, y, g, x.dtype, cfg)


def time_mix_decode(tp: dict, x: torch.Tensor, state: dict,
                    cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """The time mix from a carried state.  x: (B, T, d) (T = 1 a decode
    step, T > 1 a prompt or a chunk); state: {"S": (B, H, hd, hd) f32,
    "x_last": (B, d)}.  Returns (out (B, T, d), {"S": the final state,
    "x_last": x's last token})."""
    r, k, v, g, w = _time_mix_inputs(tp, x, cfg, state["x_last"])
    y, S1 = kops.rwkv6_stateful(r, k, v, w, tp["bonus_u"], state["S"])
    out = _finish(tp, y, g, x.dtype, cfg)
    return out, {"S": S1, "x_last": x[:, -1]}


def chan_mix_fwd(cp: dict, x: torch.Tensor, cfg: ModelConfig,
                 x_last: torch.Tensor | None = None) -> torch.Tensor:
    """The squared-ReLU channel mix; ``x_last`` (B, d): the token shifts'
    carry from the previous chunk, or None for zero.  Finch's static
    coefficients enter as they are, the JAX form's through a sigmoid."""
    dt = x.dtype
    if cfg.mix_lora:
        dx = _shifted(x, x_last) - x
        xk = x + dx * cp["mu_ck"].to(dt)
        xr = x + dx * cp["mu_cr"].to(dt)
    else:
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
