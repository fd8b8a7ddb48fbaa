"""The plain reference of the benchmark's language models: the dense
decoder, its next-token loss and its gradients, in plain PyTorch.

It follows the published descriptions as the benchmark's configuration
files state them (``perfbench/configs/*.json``) and reads the parameters
as the same nested dict the program trains: ``embedding`` (V, d),
``lm_head`` (d, V) when the embeddings are untied, ``final_norm``, and
``groups/g<i>/s<j>`` holding each slot's layers stacked ``(n, ...)``:
``ln1``, ``mix`` (``wq``, ``wk``, ``wv``, ``wo``), ``ln2`` and ``ffn``
(``wg``, ``wu``, ``wd`` of a SwiGLU MLP).

Everything is computed in float32 with TF32 off (:func:`exact_matmuls`);
the ``fp8`` numerics round both operands of every product to float8
e4m3 with a per-tensor scale first, the lower precision a faster
implementation would be tempted by (the control of ``perfbench/compare.py``).

The layer equations:

* norm: ``rmsnorm`` x / sqrt(mean(x^2) + eps) * scale, or the
  non-parametric ``layernorm_np`` (x - mean) / sqrt(var + eps);
* attention: q, k, v projections, split-half rotary embeddings at
  positions 0..S-1, causal softmax(q k^T / sqrt(hd)) v over grouped
  key/value heads, keys limited to the last ``window`` positions where
  the layer kind is windowed (``local``, ``swa``), output projection;
* SwiGLU MLP: (silu(x wg) * (x wu)) wd;
* loss: mean over tokens of logsumexp(logits) - logit[label].
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0                   # largest finite float8 e4m3 value


@contextlib.contextmanager
def exact_matmuls():
    """float32 products in float32: TF32 off for the block's duration."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 at a per-tensor scale, back in float32;
    the gradient passes straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x.detach())


class Numerics:
    """How the reference's products round their operands: ``f32`` (none)
    or ``fp8``."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"unknown numerics {kind!r}")
        self.kind = kind

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return _fp8(x) if self.kind == "fp8" else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
        return torch.einsum(eq, self.q(a), self.q(b))


def norm(p: dict, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    eps = cfg["norm_eps"]
    if cfg["norm"] == "rmsnorm":
        out = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
        return out * p["scale"]
    if cfg["norm"] == "layernorm_np":
        mean = torch.mean(x, dim=-1, keepdim=True)
        var = torch.mean((x - mean) ** 2, dim=-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + eps)
    raise ValueError(f"reference: no norm {cfg['norm']!r}")


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


def attention(p: dict, x: torch.Tensor, cfg: dict, kind: str,
              nm: Numerics) -> torch.Tensor:
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


def swiglu(p: dict, x: torch.Tensor, nm: Numerics) -> torch.Tensor:
    return nm.mm(F.silu(nm.mm(x, p["wg"])) * nm.mm(x, p["wu"]), p["wd"])


def _layers(params: dict, cfg: dict):
    """(kind, that layer's parameters) in the model's order: each group's
    pattern repeated ``n`` times, layer i of a slot being index i of its
    stacked leaves."""
    for gi, grp in enumerate(cfg["groups"]):
        slots = params["groups"][f"g{gi}"]
        for i in range(grp["n"]):
            for si, kind in enumerate(grp["pattern"]):
                yield kind, _index(slots[f"s{si}"], i)


def _index(tree: dict, i: int) -> dict:
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def loss_sum(params: dict, tokens: torch.Tensor, labels: torch.Tensor,
             cfg: dict, nm: Numerics) -> torch.Tensor:
    """The sum of the tokens' losses over the rows of ``tokens``/``labels``
    (B, S)."""
    if cfg["embed_scale"] or cfg["logit_softcap"] or cfg["qk_norm"] \
            or cfg["n_experts"]:
        raise ValueError("reference: embedding scale, logit softcap, "
                         "qk-norm and experts are not described here")
    x = params["embedding"][tokens.long()]
    for kind, p in _layers(params, cfg):
        if kind not in ("attn", "local", "swa"):
            raise ValueError(f"reference: no layer kind {kind!r}")
        x = x + attention(p["mix"], norm(p["ln1"], x, cfg), cfg, kind, nm)
        x = x + swiglu(p["ffn"], norm(p["ln2"], x, cfg), nm)
    x = norm(params["final_norm"], x, cfg)
    head = (params["embedding"].T if cfg["tie_embeddings"]
            else params["lm_head"])
    logits = nm.mm(x, head)
    nll = torch.logsumexp(logits, dim=-1) \
        - torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return nll.sum()


def loss_and_grads(params: dict, tokens: torch.Tensor,
                   labels: torch.Tensor, cfg: dict, nm: Numerics
                   ) -> tuple[torch.Tensor, dict]:
    """The training loss (the tokens' mean loss) and its gradient for
    every leaf of ``params``, one row of the batch at a time with the
    rows' gradients summed, so one row's activations are alive at once."""
    flat = flatten(params)
    names = list(flat)
    leaves = [flat[n].detach().requires_grad_() for n in names]
    tree = unflatten(params, dict(zip(names, leaves)))
    n_tok = tokens.numel()
    total = torch.zeros((), dtype=torch.float64, device=tokens.device)
    grads = [torch.zeros_like(x) for x in leaves]
    for r in range(tokens.shape[0]):
        loss = loss_sum(tree, tokens[r:r + 1], labels[r:r + 1], cfg,
                        nm) / n_tok
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        for acc, gr in zip(grads, gs):
            if gr is not None:
                acc.add_(gr)
        total += loss.detach().double()
        del loss, gs
    return total, dict(zip(names, grads))


def flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, path))
        else:
            out[path] = v
    return out


def unflatten(like: dict, flat: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in like.items():
        path = f"{prefix}/{k}" if prefix else k
        out[k] = unflatten(v, flat, path) if isinstance(v, dict) \
            else flat[path]
    return out

