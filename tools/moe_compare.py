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
    python3 tools/moe_compare.py --bwd build/other

The other version is built with ``nvcc`` from that directory (into it:
keep it under the ignored ``build/``) and called through the C interface
that has a pre-activation save but no bf16 y save (13 pointers into the
forward, 21 into the backward), with the tiles the f32 plan gives.

``--bwd`` compares the backward instead, at mixtral-8x7b's training shape
(G 2, g 1024, E 8, C 320, d 4096, f 14336, bf16): the normalized error of
each gradient against autograd of the plain version in f32 (this and the
other version), the two versions against each other, the backward's
device time in turns (other, this, this, other) beside autograd through
three ``torch.bmm``, and the time of each of its launches from a
``torch.profiler`` trace of three calls (both versions), beside the
operations bound of the route each takes.  Needs one CUDA card.  Exits
non-zero if an f32 result differs in any bit, or a bf16 one (a gradient,
under ``--bwd``) is off its plain version."""
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
    lib.moe_grouped_ffn_fwd.argtypes = [ctypes.c_void_p] * 13 + \
        [ctypes.c_int] * 11 + [ctypes.c_void_p]
    lib.moe_grouped_ffn_bwd.argtypes = [ctypes.c_void_p] * 21 + \
        [ctypes.c_int] * 8 + [ctypes.c_void_p]
    return lib


# the other version's backward launches in order (nine, the bf16 products
# on mma.sync; this version's are chip_smoke.MOE_BWD_LAUNCHES)
OTHER_BWD_LAUNCHES = ("dy", "dh", "dxin_da", "dxin_db", "dwd", "dwg", "dwu",
                      "dx", "dcombine")
TRAIN_SHAPE = (2, 1024, 8, 320, 4096, 14336)


def other_backward(other: ctypes.CDLL, dispatch, combine, x, ws, dout):
    """The other version's backward at one input: its forward (with the
    pre-activations saved) runs once here, and the returned ``fn(i)``
    runs its backward, returning (dx, dcombine, dwg, dwu, dwd)."""
    from repro_torch.kernels import moe_matmul as mm
    G, g, E, C = dispatch.shape
    d, f, dt = x.shape[-1], ws[0].shape[-1], x.dtype
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    p = mm.plan(G, g, E, C, d, f, dt, n_sm)
    ks = p["ks"]
    dev = dict(device="cuda")
    sv = dict(xin=torch.empty((G, E, C, d), dtype=dt, **dev),
              h=torch.empty((G, E, C, f), dtype=dt, **dev),
              y=torch.empty((ks, G, E, C, d), **dev),
              live=torch.empty((G, E, C), dtype=torch.int32, **dev))
    sv["a"], sv["b"] = torch.empty_like(sv["h"]), torch.empty_like(sv["h"])
    out = torch.empty_like(x)
    rc = other.moe_grouped_ffn_fwd(
        *(t.data_ptr() for t in (dispatch, combine, x, *ws, out)),
        *(sv[k].data_ptr() for k in ("xin", "h", "y", "live", "a", "b")),
        mm.ELEM[dt], G, g, E, C, d, f, p["tile"],
        p["up"]["stages"] if dt == torch.bfloat16 else 0, ks, p["per"],
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0, rc

    def fn(i=0):
        grads = (torch.empty_like(x), torch.empty(dispatch.shape, **dev),
                 torch.empty_like(ws[0]), torch.empty_like(ws[1]),
                 torch.empty_like(ws[2]))
        scratch = (torch.empty((G, E, C, d), dtype=dt, **dev),
                   torch.empty((G, E, C, f), dtype=dt, **dev),
                   torch.empty((G, E, C, f), dtype=dt, **dev),
                   torch.empty((G, E, C, d), **dev))
        rc = other.moe_grouped_ffn_bwd(
            *(t.data_ptr() for t in (dispatch, combine, dout, *ws)),
            *(sv[k].data_ptr() for k in ("xin", "h", "a", "b", "y", "live")),
            *(t.data_ptr() for t in grads + scratch), mm.ELEM[dt], G, g, E,
            C, d, f, ks, torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return grads
    return fn


def main_bwd(other_dir: str | None) -> int:
    """``--bwd``: the backward at mixtral's training shape, this version
    against autograd of the plain version and against ``other_dir``."""
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import moe_matmul as mm
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi(), flush=True)
    t0 = time.perf_counter()
    print("build", _build.build_all((mm.NAME,)),
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    log = _build.library_path(mm.NAME)
    spills = cs.print_ptxas(mm.NAME,
                            log.with_name(log.name + ".log").read_text())
    other = None if other_dir is None else load_other(
        Path(other_dir), _build._nvcc(), _build.NVCC_FLAGS)
    G, g, E, C, d, f = TRAIN_SHAPE
    bf = torch.bfloat16
    cfg = get_config("mixtral-8x7b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ws = tuple((torch.randn(s, generator=gen, device="cuda") * s[1] ** -0.5)
               .to(bf) for s in ((E, d, f), (E, d, f), (E, f, d)))
    dispatch, combine = cs.moe_route(torch, gen, cfg, g, G)
    assert dispatch.shape[-1] == C
    x = torch.randn((G, g, d), generator=gen, device="cuda").to(bf)
    dout = torch.randn((G, g, d), generator=gen, device="cuda").to(bf)
    ins = (dispatch, combine, x, *ws)
    _, saved = mm.launch_forward(ins, save=True)

    def this_bwd(i=0):
        return mm.moe_grouped_ffn_bwd(dout, dispatch, combine, *ws, saved)

    other_bwd = None if other is None else other_backward(
        other, dispatch, combine, x, ws, dout)

    # agreement: autograd of the plain version in f32 on the same values
    got = this_bwd()
    again = this_bwd()
    bits = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    want = cs._moe_grads(torch, ref, dispatch, (combine, x, *ws), dout,
                         False)
    errs = {"this": cs._moe_bwd_errs(torch, got, want)}
    if other_bwd is not None:
        theirs = other_bwd()
        errs["other"] = cs._moe_bwd_errs(torch, theirs, want)
        errs["this_vs_other"] = cs._moe_bwd_errs(torch, got, [
            t.float() for t in theirs])
        del theirs
    del got, want
    torch.cuda.empty_cache()
    print("moe_grouped_ffn_bwd normalized errors", json.dumps(dict(
        errs, two_calls_bit_identical=bits, tolerance=cs.BWD_BF16_NORM_TOL)),
        flush=True)
    bad = not bits or max(errs["this"].values()) > cs.BWD_BF16_NORM_TOL

    # time in turns, the per-launch breakdown, the bounds
    turns = [("this", this_bwd), ("this_2", this_bwd)]
    if other_bwd is not None:
        turns = [("other", other_bwd)] + turns + [("other_2", other_bwd)]
    ms = {tag: cs.time_ms(fn, 10)[0] for tag, fn in turns}
    lin = [torch.einsum("GgEC,Ggd->EGCd", dispatch.to(bf), x).flatten(
        1, 2).contiguous().requires_grad_()] + [
        w.clone().requires_grad_() for w in ws]
    lout = torch.bmm(torch.nn.functional.silu(torch.bmm(lin[0], lin[1]))
                     * torch.bmm(lin[0], lin[2]), lin[3])
    ldo = torch.randn(lout.shape, generator=gen, device="cuda").to(bf)
    ms["library"] = cs.time_ms(lambda i: torch.autograd.grad(
        lout, lin, ldo, retain_graph=True), 10)[0]
    del lin, lout, ldo
    breakdown = {"this": cs.launch_breakdown(this_bwd, cs.MOE_BWD_LAUNCHES)}
    if other_bwd is not None:
        breakdown["other"] = cs.launch_breakdown(other_bwd,
                                                 OTHER_BWD_LAUNCHES)
    live = dispatch.any(1)
    bounds = cs.moe_bwd_bounds(G, g, E, C, d, f, int(live.sum().item()),
                               int(live.any(2).any(0).sum().item()))
    slots = int(live.sum().item())
    print("moe_grouped_ffn_bwd ms", json.dumps(dict(
        shape=list(TRAIN_SHAPE), live_slots=slots, **ms, **bounds,
        breakdown=breakdown)), flush=True)
    print(cs.smi())
    if any(st or ld for k, (st, ld) in spills.items() if "bwd" in k):
        print("moe_grouped_ffn_bwd spills", spills, flush=True)
        bad = True
    return 1 if bad else 0


def main() -> int:
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import moe_matmul as mm
    args = sys.argv[1:]
    bwd = "--bwd" in args
    args = [a for a in args if a != "--bwd"]
    if not torch.cuda.is_available() or len(args) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    if bwd:
        return main_bwd(args[0] if args else None)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi(), flush=True)
    t0 = time.perf_counter()
    print("build", _build.build_all((mm.NAME,)),
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    log = _build.library_path(mm.NAME)
    cs.print_ptxas(mm.NAME, log.with_name(log.name + ".log").read_text())
    other = None if not args else load_other(
        Path(args[0]), _build._nvcc(), _build.NVCC_FLAGS)
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
            None, None, mm.ELEM[x.dtype], G, g, E, C, d, f, p["tile"], 0,
            p["ks"], p["per"], torch.cuda.current_stream().cuda_stream)
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
