"""The plain reference of the benchmark's language models: the decoder,
its next-token loss and its gradients, in plain PyTorch.

It follows the published descriptions as the benchmark's configuration
files state them (``perfbench/configs/*.json``) and reads the parameters
as the same nested dict the program trains: ``embedding`` (V, d),
``lm_head`` (d, V) when the embeddings are untied, ``final_norm``, and
``groups/g<i>/s<j>`` holding each slot's layers stacked ``(n, ...)``:
``ln1``, ``mix``, ``ln2`` and ``ffn``.

Each part is a module of this package found by name: ``norm_<norm>`` for
the configuration's norm, ``mix_<kind>`` for each layer kind's mixer, and
``ffn_<name>`` for its feed-forward (``kinds.ffn_name``: the mixer's own,
the experts, or the configuration's ``mlp``).  A block is

    x = x + mix(norm(x));   x = x + ffn(norm(x))

Everything is computed in float32 with TF32 off (:func:`exact_matmuls`);
the ``fp8`` numerics round both operands of every product to float8
e4m3 with a per-tensor scale first, the lower precision a faster
implementation would be tempted by (the control of ``perfbench/compare.py``).

The loss: mean over tokens of logsumexp(logits) - logit[label].
"""
from __future__ import annotations

import contextlib

import torch

from ..kinds import ffn_name, find

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
    if cfg["embed_scale"] or cfg["logit_softcap"] or cfg["qk_norm"]:
        raise ValueError("reference: embedding scale, logit softcap and "
                         "qk-norm are not described here")
    norm = find(f"norm_{cfg['norm']}", __package__).apply
    x = params["embedding"][tokens.long()]
    for kind, p in _layers(params, cfg):
        mix = find(f"mix_{kind}", __package__).apply
        ffn = find(f"ffn_{ffn_name(cfg, kind)}", __package__).apply
        x = x + mix(p["mix"], norm(p["ln1"], x, cfg), cfg, kind, nm)
        x = x + ffn(p["ffn"], norm(p["ln2"], x, cfg), cfg, nm)
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

