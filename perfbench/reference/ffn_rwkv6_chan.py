"""RWKV-6 Finch's channel mix (arXiv:2404.05892 §4; RWKV-LM's
``RWKV_CMix_x060``), x_{-1} = 0:

    xk = x + (x_{t-1} - x) * mu_ck;   xr = x + (x_{t-1} - x) * mu_cr
    out = sigmoid(xr W_r) * (relu(xk W_k)^2 W_v)

Its intermediates are recomputed in the backward (a checkpoint), so a
4096-token row fits beside the model."""
import torch
from torch.utils.checkpoint import checkpoint


def shifted(x: torch.Tensor) -> torch.Tensor:
    """x_{t-1} at every t of x (B, T, d), zero before the first."""
    return torch.nn.functional.pad(x, (0, 0, 1, 0))[:, :-1]


def apply(p: dict, x: torch.Tensor, cfg: dict, nm) -> torch.Tensor:
    return checkpoint(_chan_mix, p, x, nm, use_reentrant=False)


def _chan_mix(p: dict, x: torch.Tensor, nm) -> torch.Tensor:
    dx = shifted(x) - x
    xk = x + dx * p["mu_ck"]
    xr = x + dx * p["mu_cr"]
    k = torch.relu(nm.mm(xk, p["ck"])) ** 2
    return torch.sigmoid(nm.mm(xr, p["cr"])) * nm.mm(k, p["cv"])
