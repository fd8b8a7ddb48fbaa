"""The paper's own prototype model: linear regression in torch (port of
``repro.models.regression``).

Feature-partitioned exactly as in Sec 6: the parameter vector theta is split
into p chunks (the partition set Pi); each chunk's update is the paper's
f_i — a deterministic function of the full-theta snapshot.
"""
from __future__ import annotations

import torch

from ..device import resolve_device


def init_theta(n_features: int, dtype: torch.dtype = torch.float32,
               device: str | torch.device | None = None) -> torch.Tensor:
    return torch.zeros((n_features,), dtype=dtype,
                       device=resolve_device(device))


def loss(theta: torch.Tensor, X: torch.Tensor,
         y: torch.Tensor) -> torch.Tensor:
    r = X @ theta - y
    return 0.5 * torch.mean(r * r)


def grad_step(theta: torch.Tensor, X: torch.Tensor, y: torch.Tensor,
              lr: float) -> torch.Tensor:
    """One full-batch GD step (all chunk updates from the same snapshot —
    Algorithm 1 semantics), its gradient by autograd."""
    t = theta.detach().requires_grad_()
    (g,) = torch.autograd.grad(loss(t, X, y), t)
    return theta - lr * g


def chunked_grad_step(theta: torch.Tensor, X: torch.Tensor, y: torch.Tensor,
                      lr: float, n_chunks: int) -> torch.Tensor:
    """The same step computed partition-by-partition (worker view): each
    chunk's gradient uses the shared snapshot.  Equal to ``grad_step`` (the
    paper's sequential-correctness), as the JAX package asserts."""
    resid = X @ theta - y
    n = X.shape[0]
    bounds = torch.linspace(0, theta.shape[0], n_chunks + 1).to(torch.int64)
    parts = []
    for i in range(n_chunks):
        sl = slice(int(bounds[i]), int(bounds[i + 1]))
        g = X[:, sl].T @ resid / n
        parts.append(theta[sl] - lr * g)
    return torch.cat(parts)
