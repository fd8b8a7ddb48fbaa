"""A cell at a size the CPU holds: the benchmark's dense decoder at smoke
widths, in float32 so the program's plain versions and the reference
agree to rounding."""
from __future__ import annotations

import copy

from perfbench.cells import Cell

DENSE = {
    "name": "tiny-dense", "family": "dense",
    "groups": [{"pattern": ["attn"], "n": 2}],
    "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
    "d_ff": 128, "vocab_size": 256, "window": 0, "rope_theta": 10000.0,
    "norm": "layernorm_np", "norm_eps": 1e-6, "qk_norm": False,
    "mlp": "swiglu", "tie_embeddings": True, "embed_scale": False,
    "logit_softcap": 0.0, "n_experts": 0, "top_k": 0,
    "dtype": "float32", "param_dtype": "float32", "max_seq": 128}

TRAFFIC = {
    "kind": "lm_train", "batch": 2, "seq": 32, "mode": "datacentric",
    "delta": 2, "remat": "none",
    "optimizer": {"name": "adamw", "lr": 0.01, "b1": 0.9, "b2": 0.95,
                  "eps": 1e-8, "weight_decay": 0.1, "grad_clip": 1.0},
    "checked_steps": 5, "env": {}}

# a float32 program against the float32 reference: rounding alone
LIMITS = {"loss_gap": 1e-4, "grad_norm_gap": 1e-3, "change_norm_gap": 1e-3}


def cell(config: dict, **traffic) -> Cell:
    tr = copy.deepcopy(TRAFFIC)
    tr.update(traffic)
    return Cell(name=config["name"], chips=1, config=copy.deepcopy(config),
                traffic=tr, limits=dict(LIMITS), end_to_end=[],
                per_layer=[])
