#!/usr/bin/env python3
"""A quick probe of the decode and chunked-prefill attention kernels on one
card: build both sources, print ptxas' registers and spills for each
compiled kernel, and time each kernel at the serving shapes beside SDPA
(CUDA events, inputs rotated past the L2 cache, as ``chip_smoke.py``
times them), with its max abs error against the plain version.

    python3 tools/attention_probe.py

Decode: B8 over the 544-slot serving ring at head dims 64 and 128 (32 q
heads over 8 kv heads), and recurrentgemma-2b's local layers (10 over 1 of
256, a 2048-slot ring) in bf16 and f32; each also read in place from
16-slot page pools under a shuffled table (``paged==view``: bit-equal to
the gathered form) and timed so, beside the gathered pair (two
``page_gather`` calls and the gathered form).  Chunked prefill: B1 C128 over a
544-slot ring with 256 live slots at head dims 64 and 128, recurrentgemma-2b's
local layers with the 2048 window, a wrapped f32 ring; each also read in
place from 16-slot page pools under a shuffled table (``paged==view``:
bit-equal to the gathered form) and timed so, beside two ``page_gather``
calls.  A faster loop than ``chip_smoke.py`` (~1 minute with the build)
while a kernel is being changed; ``chip_smoke.py`` stays the gate."""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_paged)
from repro_torch.kernels.page_gather import (  # noqa: E402
    page_gather, prefill_page_attention, prefill_page_attention_paged)

DECODE = [(8, 544, 32, 8, 64, torch.bfloat16), (8, 544, 32, 8, 128,
                                                torch.bfloat16),
          (8, 2048, 10, 1, 256, torch.bfloat16),
          (8, 2048, 10, 1, 256, torch.float32)]
# (C, L, start, window, dtype, hd, H, KV)
PREFILL = [(128, 544, 256, 0, torch.bfloat16, 64, 32, 8),
           (128, 544, 256, 0, torch.bfloat16, 128, 32, 8),
           (128, 2048, 2200, 2048, torch.bfloat16, 256, 10, 1),
           (128, 2048, 2200, 2048, torch.float32, 256, 10, 1),
           (128, 544, 900, 0, torch.float32, 64, 32, 8)]


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_probe: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi(), flush=True)
    t0 = time.perf_counter()
    names = ("decode_attention", "prefill_page_attention")
    print("build", _build.build_all(names), time.perf_counter() - t0,
          flush=True)
    for name in names:
        so = _build.library_path(name)
        cs.print_ptxas(name, so.with_name(so.name + ".log").read_text())
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, L, H, KV, hd, dt in DECODE:
        mk = lambda s, n: torch.randn((B, s, n, hd), generator=gen,  # noqa
                                      device="cuda").to(dt)
        q, k, v = mk(1, H), mk(L, KV), mk(L, KV)
        n_live = torch.randint(1, L + 1, (B,), generator=gen, device="cuda")
        valid = torch.arange(L, device="cuda")[None, :] < n_live[:, None]
        view = decode_attention(q, k, v, valid)
        err = (view.float()
               - ref.attention_decode(q, k, v, valid).float()).abs().max()
        pk, pv, table = cs.decode_pools(torch, gen, k, v)
        same = torch.equal(
            decode_attention_paged(q, pk, pv, table, valid),
            decode_attention(q, page_gather(pk, table),
                             page_gather(pv, table), valid))
        sets = cs.rotation((q, k, v, valid))
        n = len(sets)
        psets = cs.rotation((q, pk, pv, table, valid))
        npg = len(psets)
        lib = [(a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2),
                m[:, None, None, :]) for a, b, c, m in sets]
        ms = cs.time_ms(lambda i: decode_attention(*sets[i % n]), 200)[0]
        paged_ms = cs.time_ms(lambda i: decode_attention_paged(
            *psets[i % npg]), 200)[0]
        pair_ms = cs.time_ms(lambda i: decode_attention(
            psets[i % npg][0], page_gather(*psets[i % npg][1:4:2]),
            page_gather(*psets[i % npg][2:4]), psets[i % npg][4]), 200)[0]
        sdpa = cs.time_ms(lambda i: F.scaled_dot_product_attention(
            *lib[i % n][:3], attn_mask=lib[i % n][3], enable_gqa=True),
            200 if dt == torch.bfloat16 else 10)[0]
        print("decode", B, L, H, KV, hd, dt, "err", err.item(),
              "paged==view", same, "ms", ms, "paged", paged_ms,
              "gathered pair", pair_ms, "sdpa", sdpa, flush=True)
        del sets, psets, lib
    for C, L, start, window, dt, hd, H, KV in PREFILL:
        ins = cs.chunk_inputs(torch, gen, C, L, start, dt, H=H, KV=KV, hd=hd)
        view = prefill_page_attention(*ins, window=window)
        err = (view.float() - ref.prefill_page_attention(
            *ins, window=window).float()).abs().max()
        pins = cs.paged(torch, gen, ins)
        same = torch.equal(prefill_page_attention_paged(*pins,
                                                        window=window), view)
        sets = cs.rotation(pins)
        n = len(sets)
        reps = 50 if dt == torch.bfloat16 else 5
        ms = cs.time_ms(lambda i: prefill_page_attention_paged(
            *sets[i % n], window=window), reps)[0]
        gather = cs.time_ms(lambda i: (
            page_gather(sets[i % n][1], sets[i % n][3]),
            page_gather(sets[i % n][2], sets[i % n][3])), reps)[0]
        mask = ref.prefill_mask(ins[5], ins[6], window)[:, None]
        gsets = cs.rotation(ins)
        ng = len(gsets)
        lib = [(s[0].transpose(1, 2), torch.cat([s[1], s[3]], 1).transpose(
            1, 2), torch.cat([s[2], s[4]], 1).transpose(1, 2))
            for s in gsets]
        sdpa = cs.time_ms(lambda i: F.scaled_dot_product_attention(
            *lib[i % ng], attn_mask=mask, enable_gqa=True), reps)[0]
        print("prefill", C, L, start, window, dt, hd, H, KV, "err",
              err.item(), "paged==view", same, "ms", ms, "sdpa", sdpa,
              "gather", gather, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
