#!/usr/bin/env python3
"""This checkout's grouped MoE FFN kernels on one card, alone or against
another version of ``csrc/moe_grouped_ffn.cu``: ptxas' registers and
spills, f32 results bit for bit at the CUDA tests' shapes (with a digest
of each output), and bf16 device times at the mixtral shapes that
``chip_smoke.py`` times, taken in turns (other, this, this, other) so
that both sides see the same card, beside the bound and three
``torch.bmm`` on the gathered input.

    mkdir -p build/other
    git archive <rev> src/repro_torch/kernels/csrc \\
        | tar -x --strip-components=4 -C build/other
    python3 tools/moe_compare.py build/other      # or with no argument

The other version is built with ``nvcc`` from that directory (into it:
keep it under the ignored ``build/``) and called through the earlier C
interface (f32 scratch, slots per warp, split), with the tiles the f32
plan gives.  Needs one CUDA card.  Exits non-zero if an f32 result
differs in any bit or a bf16 one is off its plain version."""
from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# (G, g, E, C, d, f, seed): the shapes of test_torch_cuda.py's
# test_moe_grouped_ffn and of its edge cases (seed 1: a random dispatch,
# several tokens in one slot)
F32_PARITY = [(1, 16, 4, 8, 32, 48, 0), (2, 24, 4, 16, 16, 64, 0),
              (1, 32, 8, 10, 64, 96, 0), (1, 8, 8, 3, 256, 512, 0),
              (1, 128, 8, 40, 128, 256, 0), (1, 300, 8, 94, 64, 128, 0),
              (1, 16, 4, 8, 64, 96, 1)]


def parity_inputs(G, g, E, C, d, f, seed, dtype=torch.float32,
                  device="cuda"):
    """dispatch, combine, x, wg, wu, wd from numpy with ``seed``: top-2
    routing through ``models.moe.route`` (seed 0) or a random dispatch
    with tokens 0 and 1 in one slot and a random combine (seed 1)."""
    from repro_torch.models.moe import route
    rng = np.random.default_rng(seed)
    if seed == 0:
        logits = torch.from_numpy(rng.standard_normal(
            (G, g, E)).astype(np.float32))
        dispatch, combine = route(torch.softmax(logits, -1), 2, C)
    else:
        dispatch = torch.from_numpy(rng.random((G, g, E, C)) < 0.15)
        dispatch[0, 0, 1, 3] = dispatch[0, 1, 1, 3] = True
        combine = torch.from_numpy(rng.random((G, g, E, C)).astype(
            np.float32))
    x = rng.standard_normal((G, g, d)).astype(np.float32)
    ws = [(rng.standard_normal(s) * s[1] ** -0.5).astype(np.float32)
          for s in ((E, d, f), (E, d, f), (E, f, d))]
    return tuple(t.to(device) for t in (dispatch, combine)) + tuple(
        torch.from_numpy(a).to(device=device, dtype=dtype)
        for a in (x, *ws))


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().contiguous().view(torch.uint8).numpy()
                          .tobytes()).hexdigest()[:16]


def load_other(src: Path, nvcc: str, flags) -> ctypes.CDLL:
    """The other version's library, built from ``src`` with ``flags``."""
    so = src / "libmoe_other.so"
    subprocess.run([nvcc, *flags, "-o", str(so),
                    str(src / "moe_grouped_ffn.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.moe_grouped_ffn_fwd.argtypes = [ctypes.c_void_p] * 11 + \
        [ctypes.c_int] * 10 + [ctypes.c_void_p]
    return lib


def main() -> int:
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import moe_matmul as mm
    if not torch.cuda.is_available() or len(sys.argv) > 2:
        print(__doc__, file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi(), flush=True)
    t0 = time.perf_counter()
    print("build", _build.build_all((mm.NAME,)),
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    log = _build.library_path(mm.NAME)
    cs.print_ptxas(mm.NAME, log.with_name(log.name + ".log").read_text())
    other = None if len(sys.argv) < 2 else load_other(
        Path(sys.argv[1]), _build._nvcc(), _build.NVCC_FLAGS)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def other_ffn(dispatch, combine, x, wg, wu, wd):
        G, g, E, C = dispatch.shape
        d, f = x.shape[-1], wg.shape[-1]
        p = mm.plan(G, g, E, C, d, f, torch.float32, n_sm)
        f32 = dict(dtype=torch.float32, device="cuda")
        out = torch.empty_like(x)
        xin = torch.empty((G, E, C, d), **f32)
        h = torch.empty((G, E, C, f), **f32)
        y = torch.empty((p["ks"], G, E, C, d), **f32)
        live = torch.empty((G, E, C), dtype=torch.int32, device="cuda")
        rc = other.moe_grouped_ffn_fwd(
            dispatch.data_ptr(), combine.data_ptr(), x.data_ptr(),
            wg.data_ptr(), wu.data_ptr(), wd.data_ptr(), out.data_ptr(),
            xin.data_ptr(), h.data_ptr(), y.data_ptr(), live.data_ptr(),
            mm.ELEM[x.dtype], G, g, E, C, d, f, p["tile"], p["ks"],
            p["per"], torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return out

    differ = 0
    for shape in F32_PARITY:
        ins = parity_inputs(*shape)
        this = mm.moe_grouped_ffn(*ins)
        row = dict(shape=list(shape), this=digest(this), n_sm=n_sm)
        if other is not None:
            o = other_ffn(*ins)
            row.update(other=digest(o), equal=torch.equal(o, this))
            differ += not row["equal"]
        print("f32 bits", json.dumps(row), flush=True)

    cfg = get_config("mixtral-8x7b")
    E, d, f, bf = cfg.n_experts, cfg.d_model, cfg.d_ff, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)
    ws = tuple((torch.randn(s, generator=gen, device="cuda") * s[1] ** -0.5)
               .to(bf) for s in ((E, d, f), (E, d, f), (E, f, d)))
    bad = 0
    for name, g in cs.MOE_SHAPES:
        dispatch, combine = cs.moe_route(torch, gen, cfg, g)
        x = torch.randn((1, g, d), generator=gen, device="cuda").to(bf)
        got = mm.moe_grouped_ffn(dispatch, combine, x, *ws)
        norm = cs._moe_norm_err(torch, got, ref.moe_grouped_ffn(
            dispatch, combine, x, *ws))[1]
        bad += not norm <= cs.BF16_TOL
        slots = int(dispatch.any(1).sum().item())
        experts = int(dispatch.any(3).any(1).sum().item())
        need = experts * 3 * d * f * 2 + cs.nbytes(dispatch, combine, x, got)
        b_ms, b_by = cs.bound(need, 6.0 * d * f * slots, "bfloat16")
        sets = cs.rotation((dispatch, combine, x))
        n = len(sets)
        xins = [torch.einsum("GgEC,Ggd->ECd", s[0].to(bf), s[2]).contiguous()
                for s in sets]

        def library(i):
            xin = xins[i % n]
            h = torch.nn.functional.silu(torch.bmm(xin, ws[0])) \
                * torch.bmm(xin, ws[1])
            return torch.bmm(h, ws[2])
        iters = 40 if g <= 128 else 10
        turns = [("this", mm.moe_grouped_ffn), ("this_2", mm.moe_grouped_ffn)]
        if other is not None:
            turns = [("other", other_ffn)] + turns + [("other_2", other_ffn)]
        ms = {tag: cs.time_ms(lambda i: fn(*sets[i % n], *ws), iters)[0]
              for tag, fn in turns}
        ms["bmm"] = cs.time_ms(library, iters)[0]
        print("bf16 ms", json.dumps(dict(
            case=name, shape=[1, g, E, dispatch.shape[-1], d, f],
            live_experts=experts, live_slots=slots, normalized_err=norm,
            bound_ms=b_ms, bound_by=b_by, plan=mm.plan(
                1, g, E, dispatch.shape[-1], d, f, bf, n_sm), **ms)),
            flush=True)
        del sets, xins
    print(cs.smi())
    print(f"f32 shapes differing: {differ} of {len(F32_PARITY)}; bf16 "
          f"shapes off their plain version: {bad}", flush=True)
    return 1 if differ or bad else 0


if __name__ == "__main__":
    sys.exit(main())
