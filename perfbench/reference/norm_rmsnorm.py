"""RMSNorm: x / sqrt(mean(x^2) + eps) * scale."""
import torch


def apply(p: dict, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    out = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True)
                          + cfg["norm_eps"])
    return out * p["scale"]
