"""The SwiGLU MLP: (silu(x wg) * (x wu)) wd."""
import torch
import torch.nn.functional as F


def apply(p: dict, x: torch.Tensor, cfg: dict, nm) -> torch.Tensor:
    return nm.mm(F.silu(nm.mm(x, p["wg"])) * nm.mm(x, p["wu"]), p["wd"])
