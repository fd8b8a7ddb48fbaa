"""The reference's training steps: AdamW with global-norm clipping and
decoupled weight decay, driven by the ParameterDB's delta-stale schedule.

The schedule (the paper's admissible delay, counted in steps): step t
(from 1) takes its gradient at the parameters of step max(t - 1 - delta,
0), theta_0 being the initial ones, and applies it to the parameters of
step t - 1.  Only the versions some later step reads are kept.

AdamW, per leaf, in float32 (t the step, g the gradient scaled by
min(1, clip / ||all gradients||)):

    m = b1 m + (1 - b1) g;   v = b2 v + (1 - b2) g^2
    p = p - lr (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd p)
"""
from __future__ import annotations

import dataclasses

import torch

from .model import (Numerics, exact_matmuls, flatten, loss_and_grads,
                    unflatten)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float
    b1: float
    b2: float
    eps: float
    weight_decay: float
    grad_clip: float


@dataclasses.dataclass
class Trajectory:
    losses: list[float]              # each step's training loss
    first_grad_norms: dict           # leaf -> ||clipped gradient of step 1||
    change_norms: dict               # leaf -> ||theta_steps - theta_0||


def clip_scale(grads: dict, clip: float) -> torch.Tensor:
    total = torch.sqrt(sum(torch.linalg.vector_norm(g).double() ** 2
                           for g in grads.values()))
    if clip <= 0:
        return torch.ones((), dtype=torch.float32, device=total.device)
    return torch.clamp(clip / torch.clamp(total, min=1e-9), max=1.0).float()


def adamw_step(params: dict, grads: dict, m: dict, v: dict, t: int,
               opt: AdamW) -> None:
    """One AdamW step of the flat dicts ``params``, ``m`` and ``v``, in
    place."""
    scale = clip_scale(grads, opt.grad_clip)
    bc1, bc2 = 1 - opt.b1 ** t, 1 - opt.b2 ** t
    for name, p in params.items():
        g = grads[name] * scale
        m[name].mul_(opt.b1).add_(g, alpha=1 - opt.b1)
        v[name].mul_(opt.b2).add_(g * g, alpha=1 - opt.b2)
        upd = (m[name] / bc1) / (torch.sqrt(v[name] / bc2) + opt.eps)
        upd.add_(p, alpha=opt.weight_decay)
        p.sub_(upd, alpha=opt.lr)


def follow(tree0: dict, batches, cfg: dict, opt: AdamW, delta: int,
           numerics: str = "f32") -> Trajectory:
    """Run ``len(batches)`` delta-stale AdamW steps from ``tree0`` (the
    initial parameters as the nested dict of ``model.py``, float32, left
    as they are) and return the numbers the benchmark compares.
    ``batches`` holds one callable per step returning (tokens, labels),
    so a step's batch is made when the step needs it."""
    nm = Numerics(numerics)
    params0 = flatten(tree0)
    steps = len(batches)
    reads = [max(t - 1 - delta, 0) for t in range(1, steps + 1)]
    kept = {0: params0}
    theta = {k: x.detach().clone() for k, x in params0.items()}
    m = {k: torch.zeros_like(x) for k, x in theta.items()}
    v = {k: torch.zeros_like(x) for k, x in theta.items()}
    losses, first = [], {}
    with exact_matmuls():
        for t in range(1, steps + 1):
            tokens, labels = batches[t - 1]()
            loss, grads = loss_and_grads(
                unflatten(tree0, kept[reads[t - 1]]), tokens, labels, cfg,
                nm)
            del tokens, labels
            losses.append(float(loss))
            if t == 1:
                scale = clip_scale(grads, opt.grad_clip)
                first = {k: float(torch.linalg.vector_norm(g * scale))
                         for k, g in grads.items()}
            adamw_step(theta, grads, m, v, t, opt)
            del grads
            if t in reads[t:]:
                kept[t] = {k: x.clone() for k, x in theta.items()}
            for j in [j for j in kept if j and j not in reads[t:]]:
                del kept[j]
    change = {k: float(torch.linalg.vector_norm(theta[k] - params0[k]))
              for k in theta}
    return Trajectory(losses, first, change)
