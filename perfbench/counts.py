"""The yardstick's arithmetic: the H100's published peaks, a launch's least
time, the live work of the attention kernels, and the model FLOPs of a
trained token (summed over the parts' descriptions, ``kinds/``).

A launch's bound is the larger of its operations over the peak FLOP/s and
its bytes over the peak bandwidth.  Work is counted as the inputs need
it: only (query, key) pairs the mask keeps, each input byte read once
and each output byte written once, whatever a kernel reads again.
"""
from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12              # H100 SXM, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, no sparsity
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def bound_s(nbytes: float, flops: float, dtype: str = "bfloat16") -> float:
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def live_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps: the work of one head."""
    if not causal:
        return S * S if window <= 0 else sum(
            S - max(0, q - window + 1) for q in range(S))
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return sum(min(q + 1, window) for q in range(S))


def flash_fwd(B, S, H, KV, hd, causal=True, window=0, dtype="bfloat16"):
    """(bytes, FLOPs) of one training forward: q, k, v read, the output
    and the rows' f32 log-sum-exp written; two products a live pair."""
    e = DTYPE_BYTES[dtype]
    nbytes = B * S * (2 * H + 2 * KV) * hd * e + B * H * S * 4
    return nbytes, 4.0 * hd * H * B * live_pairs(S, causal, window)


def flash_bwd(B, S, H, KV, hd, causal=True, window=0, dtype="bfloat16"):
    """(bytes, FLOPs) of one backward: q, k, v, o, dO and the log-sum-exp
    read, dQ, dK, dV written; five products a live pair (the scores
    recomputed, dP, dV, dQ, dK), 2.5 times the forward's."""
    e = DTYPE_BYTES[dtype]
    nbytes = (B * S * (4 * H + 4 * KV) * hd * e + B * H * S * 4)
    return nbytes, 10.0 * hd * H * B * live_pairs(S, causal, window)


def layer_kinds(cfg: dict) -> list[str]:
    return [k for grp in cfg["groups"] for _ in range(grp["n"])
            for k in grp["pattern"]]


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def model_flops_per_token(cfg: dict, seq: int) -> float:
    """Training FLOPs a token: 6 x the weights of the products a token
    passes through, plus each part's further FLOPs (attention's scores),
    forward and backward, summed over the parts' descriptions
    (``kinds/``: each layer's mixer and feed-forward, the head); no
    recomputation.  A part with no description raises."""
    from perfbench import kinds
    weights, extra = 0, 0.0
    for desc in kinds.parts(cfg):
        weights += desc.weights(cfg)
        extra += desc.flops(cfg, seq)
    return 6.0 * weights + extra
