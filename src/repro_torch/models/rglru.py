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
card, autograd of the plain version on the CPU).  Serving carries a state
per sequence (``init_rglru_state``: the f32 recurrence state and the last
``conv_width - 1`` conv inputs): ``rglru_decode`` runs a prompt (from the
zero state), a prompt chunk or a decode step from it through
``ops.rglru_stateful`` (the forward kernel from the carried state on the
card).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import param_for
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
        "wa": P(stack + (dr, dr), lead + ("ffn", "ffn2"), scale=0.01,
                keep_f32=True),
        "ba": P(stack + (dr,), lead + ("ffn",), init="zeros"),
        "wi": P(stack + (dr, dr), lead + ("ffn", "ffn2"), scale=0.01,
                keep_f32=True),
        "bi": P(stack + (dr,), lead + ("ffn",), init="zeros"),
        "lam": P(stack + (dr,), lead + ("ffn",), scale=0.5),
        "wo": P(stack + (dr, d), lead + ("ffn", "embed")),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 carry: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv over time.  u: (B, T, dr); w: (cw, dr); b:
    (dr,); carry: (B, cw-1, dr) the previous inputs (decode, a prompt
    chunk), or None for zero history.  The history is concatenated in
    front (zero rows, or the carry), which DTensor propagates on every
    torch version (a pad it does not)."""
    cw, T = w.shape[0], u.shape[1]
    hist = ([torch.zeros_like(u[:, :1])] * (cw - 1) if carry is None
            else [carry.to(u.dtype)])
    up = torch.cat(hist + [u], dim=1)
    out = torch.zeros_like(u)
    for i in range(cw):
        out = out + up[:, i:i + T] * w[i].to(u.dtype)
    return out + b.to(u.dtype)


def _gates(p: dict, u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    uf = u.float()
    f32 = torch.float32
    ra = torch.sigmoid(uf @ param_for(p["wa"], f32, uf) + p["ba"].float())
    log_a = -_C * F.softplus(p["lam"].float()) * ra
    a = torch.exp(log_a)
    i = torch.sigmoid(uf @ param_for(p["wi"], f32, uf) + p["bi"].float())
    return a.to(u.dtype), i.to(u.dtype)


def rglru_fwd(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    y = F.gelu(x @ param_for(p["wy"], dt, x), approximate="tanh")
    u = _causal_conv(x @ param_for(p["wx"], dt, x), p["conv_w"],
                     p["conv_b"])
    a, i = _gates(p, u)
    h = kops.rglru(i * u, a)
    return (y * h) @ param_for(p["wo"], dt, x)


def rglru_decode(p: dict, x: torch.Tensor, state: dict,
                 cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """The block from a carried state.  x: (B, T, d) (T = 1 a decode step,
    T > 1 a prompt or a chunk); state: {"h": (B, dr) f32, "conv": (B, cw-1, dr)
    the last conv inputs}.  Returns (out (B, T, d), the new state: the
    recurrence's final state and the last cw-1 inputs across the carry and
    the chunk), new tensors."""
    dt = x.dtype
    y = F.gelu(x @ param_for(p["wy"], dt, x), approximate="tanh")
    u_in = x @ param_for(p["wx"], dt, x)
    u = _causal_conv(u_in, p["conv_w"], p["conv_b"], state["conv"])
    a, i = _gates(p, u)
    h_seq, hT = kops.rglru_stateful(i * u, a, state["h"])
    out = (y * h_seq) @ param_for(p["wo"], dt, x)
    conv = state["conv"]
    new_conv = torch.cat([conv, u_in.to(conv.dtype)],
                         dim=1)[:, -conv.shape[1]:]
    return out, {"h": hT, "conv": new_conv}


def rglru_state_axes(stack_dims: int = 0) -> dict:
    """Logical axes of ``init_rglru_state``'s leaves."""
    lead = ("layers",) * stack_dims
    return {"h": lead + ("batch", None), "conv": lead + ("batch", None, None)}


def init_rglru_state(cfg: ModelConfig, batch: int,
                     stack: tuple[int, ...] = (),
                     device: str | torch.device = "cpu") -> dict:
    """Zero serving state: {"h": stack + (batch, dr) f32, "conv": stack +
    (batch, cw-1, dr) in the compute dtype}."""
    dr, cw = cfg.rnn_width, cfg.conv_width
    return {"h": torch.zeros(stack + (batch, dr), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros(stack + (batch, cw - 1, dr),
                                dtype=cfg.dtype, device=device)}
