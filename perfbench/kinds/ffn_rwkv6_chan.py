"""RWKV-6's channel mix: the key, value and receptance products (d x d_ff,
d_ff x d, d x d) on cuBLAS, around squared ReLU, sigmoid and token
shifts."""

SOURCES = ()


def weights(cfg: dict) -> int:
    d = cfg["d_model"]
    return 2 * d * cfg["d_ff"] + d * d


def flops(cfg: dict, seq: int) -> float:
    return 0.0


def launches(cfg: dict, tr: dict) -> dict:
    return {}


def kernels(cfg: dict, tr: dict) -> dict:
    return {}
