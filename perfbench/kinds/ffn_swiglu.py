"""The SwiGLU MLP: gate, up and down products, on cuBLAS."""

SOURCES = ()


def weights(cfg: dict) -> int:
    return 3 * cfg["d_model"] * cfg["d_ff"]


def flops(cfg: dict, seq: int) -> float:
    return 0.0


def launches(cfg: dict, tr: dict) -> dict:
    return {}


def kernels(cfg: dict, tr: dict) -> dict:
    return {}
