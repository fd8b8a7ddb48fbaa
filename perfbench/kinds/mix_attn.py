"""Global causal self-attention (``attn``): the q, k, v and output
projections around the flash kernel, one forward and one backward launch
a layer a step, the forward twice under remat."""
from perfbench import counts
from perfbench.kinds import Launch

SOURCES = ("flash_attention",)


def weights(cfg: dict) -> int:
    H, KV, hd = cfg["n_heads"], cfg["n_kv_heads"], counts.head_dim(cfg)
    return cfg["d_model"] * hd * (2 * H + 2 * KV)


def flops(cfg: dict, seq: int, window: int = 0) -> float:
    """The scores' two products a live key, forward and backward: 12 H hd
    a live (query, key) pair over the sequence."""
    H, hd = cfg["n_heads"], counts.head_dim(cfg)
    return 12.0 * H * hd * counts.live_pairs(seq, True, window) / seq


def launches(cfg: dict, tr: dict) -> dict:
    return {"flash_attention": 1 if tr["remat"] == "none" else 2,
            "flash_attention_bwd": 1}


def kernels(cfg: dict, tr: dict, window: int = 0) -> dict:
    shape = (tr["batch"], tr["seq"], cfg["n_heads"], cfg["n_kv_heads"],
             counts.head_dim(cfg), True, window)
    return {"flash_attention": Launch("flash_fwd_kernel",
                                      *counts.flash_fwd(*shape)),
            "flash_attention_bwd": Launch("flash_bwd_",
                                          *counts.flash_bwd(*shape))}
