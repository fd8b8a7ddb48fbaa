"""Quickstart on the PyTorch port (the counterpart of
``examples/quickstart.py``): build a zoo model, train a few steps, then
serve from it through the dense ring cache.

    PYTHONPATH=src python examples/torch_quickstart.py               # card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.sync import SyncConfig
from repro_torch.data import LMBatchSpec, make_lm_batch
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import paramlib
from repro_torch.models.transformer import decode_step, model_specs, prefill
from repro_torch.optim import OptConfig, make_optimizer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand-written kernels) or cpu (plain "
                         "versions)")
    dev = resolve_device(ap.parse_args(argv).device)

    # 1. pick an architecture (smoke = the reduced same-family config)
    cfg = get_smoke_config("llama3.2-1b")
    specs = model_specs(cfg)
    params = paramlib.init_tree(specs,
                                torch.Generator(device=dev).manual_seed(0))
    print(f"{cfg.name}: {paramlib.param_count(specs):,} params (reduced)")

    # 2. train a few steps under data-centric synchronization
    opt = make_optimizer(OptConfig(lr=3e-3))
    step = make_train_step(cfg, opt, SyncConfig(mode="datacentric"))
    opt_state = opt.init(params)
    spec = LMBatchSpec(batch=4, seq_len=64, vocab_size=cfg.vocab_size, seed=0)
    losses = []
    for t in range(20):
        params, opt_state, m = step(params, opt_state,
                                    make_lm_batch(spec, t, dev))
        losses.append(float(m["loss"]))
        if t % 5 == 0:
            print(f"  step {t:3d}  loss {losses[-1]:.4f}")

    # 3. serve: prefill a prompt into the dense ring, decode a few tokens
    prompt = torch.randint(0, cfg.vocab_size, (2, 16), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(7))
    with torch.no_grad():
        logits, cache = prefill(params, prompt, cfg, cache_len=32)
        tok = torch.argmax(logits, -1)[:, None]
        out = [int(tok[0, 0])]
        for i in range(8):
            logits, cache = decode_step(params, cache, tok,
                                        torch.tensor(16 + i, device=dev), cfg)
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            out.append(int(tok[0, 0]))
    print("decoded token ids:", out)
    return {"losses": losses, "decoded": out}


if __name__ == "__main__":
    main()
