"""The non-parametric LayerNorm: (x - mean) / sqrt(var + eps)."""
import torch


def apply(p: dict, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mean) ** 2, dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + cfg["norm_eps"])
