"""RWKV-6 Finch's time mix (``rwkv6``): the r, k, v, g and output products
and the two LoRAs (the token shift's shared A and five B, the decay's pair)
on cuBLAS, around the WKV kernels of ``rwkv6_scan``: one forward launch a
layer a step (two under remat) and one backward.  Its feed-forward is the
channel mix.

The WKV's own work (``chip_smoke.check_rwkv6_scan`` and ``_bwd`` count it
alike): 5 hd^2 FLOPs a head a token forward, 14 backward, f32 on the CUDA
cores; bytes as the launch's inputs and outputs need them: r, k, v (and dy)
in the compute dtype, w, u f32, y out; the backward writes dr, dk, dv in
the compute dtype and dw, du f32.  A forward launch runs
``rwkv6_fwd_sum_kernel`` and ``rwkv6_fwd_kernel``; a backward launch
``rwkv6_bwd_sum_kernel``, ``rwkv6_bwd_dv_kernel``, ``rwkv6_bwd_kernel`` and
``rwkv6_du_kernel``, whose only common part is ``rwkv6_``: so the
backward's device name holds the forward's kernels too, and its share is
read with the forward's."""
from perfbench import counts
from perfbench.kinds import Launch

FFN = "rwkv6_chan"
SOURCES = ("rwkv6_scan",)
MIX = 5                           # the token shift's targets: w, k, v, r, g
FWD_FLOPS, BWD_FLOPS = 5.0, 14.0  # a head's hd^2, a token


def weights(cfg: dict) -> int:
    d = cfg["d_model"]
    hdim = cfg["n_heads"] * counts.head_dim(cfg)
    return (4 * d * hdim + hdim * d + 2 * d * MIX * cfg["mix_lora"]
            + d * cfg["decay_lora"] + cfg["decay_lora"] * hdim)


def flops(cfg: dict, seq: int) -> float:
    hd = counts.head_dim(cfg)
    return (FWD_FLOPS + BWD_FLOPS) * hd * hd * cfg["n_heads"]


def launches(cfg: dict, tr: dict) -> dict:
    return {"rwkv6_scan": 1 if tr["remat"] == "none" else 2,
            "rwkv6_scan_bwd": 1}


def kernels(cfg: dict, tr: dict) -> dict:
    H, hd = cfg["n_heads"], counts.head_dim(cfg)
    e = counts.DTYPE_BYTES[cfg["dtype"]]
    heads = tr["batch"] * tr["seq"] * H          # (token, head) pairs
    n, u = heads * hd, 4 * H * hd                # elements of r; u's bytes
    return {"rwkv6_scan": Launch(
                "rwkv6_fwd", 3 * n * e + 4 * n + u + n * e,
                FWD_FLOPS * hd * hd * heads, "float32"),
            "rwkv6_scan_bwd": Launch(
                "rwkv6_", (4 * n * e + 4 * n + u) + (3 * n * e + 4 * n + u),
                BWD_FLOPS * hd * hd * heads, "float32")}
