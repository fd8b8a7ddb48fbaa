"""Griffin recurrent block: causal conv1d + RG-LRU gated linear recurrence
(port of ``repro.models.rglru``, arXiv:2402.19427; recurrentgemma uses this
block 2:1 with local attention).

    branch_y = GeLU(x W_y)
    u        = x W_x ; u = CausalConv1d(u, width)
    a_t      = exp(-c * softplus(Lambda) * sigmoid(u W_a + b_a))
    i_t      = sigmoid(u W_i + b_i)
    h_t      = a_t h_{t-1} + sqrt(1-a_t^2) (i_t * u_t)
    out      = (branch_y * h) W_o

In the JAX package's order of operations: the conv as the same
``conv_width``-step loop, the gates in f32 (products by ``wa`` and ``wi``
included), a and i cast to the compute dtype, the tanh GeLU.  The
full-sequence forward goes through ``ops.rglru`` (the CUDA kernels on the
card, autograd of the plain version on the CPU).  The stateful decode path
(``rglru_decode``, ``init_rglru_state``) comes with recurrent serving.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from .config import ModelConfig
from .paramlib import P

_C = 8.0  # Griffin's fixed decay sharpness constant


def rglru_specs(cfg: ModelConfig, stack: tuple[int, ...] = ()) -> dict:
    lead = ("layers",) * len(stack)
    d, dr, cw = cfg.d_model, cfg.rnn_width, cfg.conv_width
    return {
        "wy": P(stack + (d, dr), lead + ("embed", "ffn")),
        "wx": P(stack + (d, dr), lead + ("embed", "ffn")),
        "conv_w": P(stack + (cw, dr), lead + (None, "ffn"), scale=0.1),
        "conv_b": P(stack + (dr,), lead + ("ffn",), init="zeros"),
        "wa": P(stack + (dr, dr), lead + ("ffn", "ffn2"), scale=0.01),
        "ba": P(stack + (dr,), lead + ("ffn",), init="zeros"),
        "wi": P(stack + (dr, dr), lead + ("ffn", "ffn2"), scale=0.01),
        "bi": P(stack + (dr,), lead + ("ffn",), init="zeros"),
        "lam": P(stack + (dr,), lead + ("ffn",), scale=0.5),
        "wo": P(stack + (dr, d), lead + ("ffn", "embed")),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time from zero history.  u: (B, T, dr);
    w: (cw, dr); b: (dr,)."""
    cw, T = w.shape[0], u.shape[1]
    up = F.pad(u, (0, 0, cw - 1, 0))
    out = torch.zeros_like(u)
    for i in range(cw):
        out = out + up[:, i:i + T] * w[i].to(u.dtype)
    return out + b.to(u.dtype)


def _gates(p: dict, u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    uf = u.float()
    ra = torch.sigmoid(uf @ p["wa"].float() + p["ba"].float())
    log_a = -_C * F.softplus(p["lam"].float()) * ra
    a = torch.exp(log_a)
    i = torch.sigmoid(uf @ p["wi"].float() + p["bi"].float())
    return a.to(u.dtype), i.to(u.dtype)


def rglru_fwd(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    y = F.gelu(x @ p["wy"].to(dt), approximate="tanh")
    u = _causal_conv(x @ p["wx"].to(dt), p["conv_w"], p["conv_b"])
    a, i = _gates(p, u)
    h = kops.rglru(i * u, a)
    return (y * h) @ p["wo"].to(dt)
