"""End-to-end training on the PyTorch port (the counterpart of
``examples/train_100m.py``): train a ~110M-parameter llama-family model
for a few hundred steps on synthetic data, with checkpoints and restart.

    PYTHONPATH=src python examples/torch_train_100m.py --steps 300
    PYTHONPATH=src python examples/torch_train_100m.py --steps 300 --resume

Checkpoints are in the JAX package's on-disk format (``{"p": params, "o":
opt_state}``), so either package resumes the other's.
"""
import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import latest_step, load_state, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.core.sync import SyncConfig
from repro_torch.data import LMBatchSpec, make_lm_batch
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import paramlib
from repro_torch.models.config import BlockGroup, ModelConfig
from repro_torch.models.transformer import model_specs
from repro_torch.optim import OptConfig, make_optimizer


def config_100m() -> ModelConfig:
    """~110M params: 12L d768 ff2048 vocab 32k (llama-family)."""
    base = get_config("llama3.2-1b")
    return dataclasses.replace(
        base, name="llama-110m", groups=(BlockGroup(("attn",), 12),),
        d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048, head_dim=64,
        vocab_size=32000, max_seq=2048, dtype=torch.float32)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_100m_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand-written kernels) or cpu (plain "
                         "versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = config_100m()
    specs = model_specs(cfg)
    params = paramlib.init_tree(specs,
                                torch.Generator(device=dev).manual_seed(0))
    print(f"{cfg.name}: {paramlib.param_count(specs)/1e6:.1f}M params")

    opt = make_optimizer(OptConfig(lr=1e-3, weight_decay=0.01))
    step = make_train_step(cfg, opt, SyncConfig())
    opt_state = opt.init(params)
    spec = LMBatchSpec(batch=args.batch, seq_len=args.seq,
                       vocab_size=cfg.vocab_size, seed=0)

    start = 0
    if args.resume:
        ls = latest_step(args.ckpt_dir)
        if ls is not None:
            state = load_state(args.ckpt_dir, ls,
                               {"p": params, "o": opt_state})
            params, opt_state = state["p"], state["o"]
            start = ls
            print(f"resumed from step {ls}")

    losses = []
    t0 = time.time()
    for t in range(start, args.steps):
        params, opt_state, m = step(params, opt_state,
                                    make_lm_batch(spec, t, dev))
        losses.append(float(m["loss"]))
        if t % 10 == 0 or t == args.steps - 1:
            dt = time.time() - t0
            print(f"step {t:4d}  loss {losses[-1]:.4f}  "
                  f"({dt/max(t-start+1,1):.1f}s/step)", flush=True)
        if (t + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, t + 1,
                            {"p": params, "o": opt_state})
    save_checkpoint(args.ckpt_dir, args.steps, {"p": params, "o": opt_state})
    print("done")
    return {"losses": losses, "start": start}


if __name__ == "__main__":
    main()
