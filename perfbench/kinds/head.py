"""The output head: the logits' product over the vocabulary (the tied
embedding's or its own), on cuBLAS; the embedding lookup is no product."""

SOURCES = ()


def weights(cfg: dict) -> int:
    return cfg["d_model"] * cfg["vocab_size"]


def flops(cfg: dict, seq: int) -> float:
    return 0.0


def launches(cfg: dict, tr: dict) -> dict:
    return {}


def kernels(cfg: dict, tr: dict) -> dict:
    return {}
