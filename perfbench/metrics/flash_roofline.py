"""The flash kernels' share of their roofline: the sum of each traced
launch's bound over the sum of their device time (``flash_fwd_kernel``,
``flash_bwd_*``), the launches counted by the program's counter and their
shapes those of the cell."""
from perfbench import counts

FWD, BWD = "flash_fwd_kernel", "flash_bwd_"


def read(run):
    ms = [op.dur_us for op in run.trace.ops
          if FWD in op.name or BWD in op.name]
    n_fwd = run.launches.get("flash_attention", 0)
    n_bwd = run.launches.get("flash_attention_bwd", 0)
    if not ms or not (n_fwd or n_bwd):
        return None
    cfg, tr = run.cfg, run.traffic
    B, S = tr["batch"], tr["seq"]
    H, KV, hd = cfg["n_heads"], cfg["n_kv_heads"], counts.head_dim(cfg)
    bound = 0.0
    for kind in set(counts.layer_kinds(cfg)):
        share = counts.layer_kinds(cfg).count(kind) / len(
            counts.layer_kinds(cfg))
        window = cfg["window"] if kind in ("local", "swa") else 0
        bound += share * (
            n_fwd * counts.bound_s(*counts.flash_fwd(B, S, H, KV, hd,
                                                      True, window))
            + n_bwd * counts.bound_s(*counts.flash_bwd(B, S, H, KV, hd,
                                                        True, window)))
    return 100.0 * bound / (sum(ms) / 1e6)
