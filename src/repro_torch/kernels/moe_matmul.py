"""CUDA grouped MoE FFN (``csrc/moe_grouped_ffn.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/moe_matmul.py``
(``moe_grouped_ffn``, ``pallas_call`` at :77): per (token group, expert)
``xin = dispatchᵀ x``, ``y = (silu(xin wg) * (xin wu)) wd`` and
``out = sum_e combine_e y_e``, every product accumulated in f32 and the
output rounded once to x's dtype.  Bound on the H100: bytes at the serving
shapes (each expert with a token reads its three weight matrices once).
Four launches: dispatch (slot rows and liveness read from the bool
``dispatch`` on the device), the gated up product, the down product
(split over f when its tiles alone would leave SMs idle, as at decode)
and the combine; no atomics, no host synchronisation, and experts or
slots without a token are never loaded or computed.

bf16 runs its products on the tensor cores (``wgmma``, the weights'
output columns as the M side and a tile of 8-160 slots as the N side,
32 KB of weights a stage streamed raw through a ring of ``cp.async``
stages); xin and H are bf16 scratch (H computed in f32 and rounded once),
the down product's split partials and the combine f32.  f32 stays on the
CUDA cores with f32 scratch.  :func:`plan` picks the tiles, stages and
split from the shapes alone.  The wrapper allocates the scratch.  Its
plain version is ``ref.moe_grouped_ffn``.

The gradient (no TPU kernel: the JAX package trains through autodiff of
``ref.moe_grouped_ffn``) is ``moe_grouped_ffn_bwd`` in the same source:
dx, dcombine (f32) and the three weight gradients, no atomics, exact
zeros for an expert without a token.  bf16 takes eight launches: each
expert's live slots listed on the device, the dy gather, five products
on ``wgmma`` in one warp-specialised persistent kernel (dh with the
SwiGLU gradient in its epilogue, dxin as one product of depth 2f, dwd,
dwg and dwu in one launch, dcombine against the forward's bf16 y) that
walk the listed rows only, and the dx gather.  f32 takes nine, on the
CUDA cores.  :func:`plan_bwd` states its tiles, tile queues and grids
from the shapes alone.  :class:`MoEGroupedFFN` is the autograd function
over the two.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .flash_attention import ELEM

NAME = "moe_grouped_ffn"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"moe_grouped_ffn_fwd": [_P] * 14 + [_I] * 11 + [_P],
              "moe_grouped_ffn_tiles": [_I, _I, _I],
              "moe_grouped_ffn_bwd": [_P] * 22 + [_I] * 9 + [_P],
              "moe_grouped_ffn_bwd_tiles": [_I],
              "moe_grouped_ffn_bwd_queue": [_I] * 8,
              "moe_grouped_ffn_rows": [_P, _P, _I, _I, _I, _P]}
MAX_GRID = 65535
SM_SMEM = 233_472       # shared memory of one H100 SM, 1 KB kept per block
# f32, on the CUDA cores
DK = 32                 # depth of one chunk of the products
COLS = 128              # output columns per block
WARPS = 8               # warps per block, 1, 4 or 8 slots each
# bf16, on the tensor cores (csrc: TC_K, TC_THREADS, tc_cols, tc_stages)
TC_K = 64               # depth of one stage
TC_THREADS = 256        # two warpgroups
TC_COLS = {"up": 128, "down": 256}   # weight output columns per block
TC_WBYTES = 4 * TC_K * 64 * 2        # weight bytes of one stage
SLOT_TILES = (8, 16, 32, 48, 64, 96, 128, 160)   # wgmma widths built
# the backward (csrc: TB_*, SW_*, ROWS_THREADS): bf16 products on wgmma in
# persistent blocks of a producer and two consumer warpgroups, TB_BM x
# TB_BN output tiles, TB_BK deep stages through a ring of TB_STAGES (the
# weight gradients: TB_WG_STAGES, and their bf16 tile staged in shared
# memory for its store); f32 products and dcombine on the CUDA cores in
# blocks of SW_BM x SW_BN, SW_BK deep
TB_BM, TB_BN, TB_BK, TB_THREADS = 128, 256, 64, 384
TB_STAGES, TB_WG_STAGES = 4, 3
TB_PRODUCER_REGS, TB_CONSUMER_REGS = 48, 224
TB_SMEM = 1024 + TB_STAGES * (TB_BM + TB_BN) * TB_BK * 2
TB_WG_SMEM = 1024 + TB_WG_STAGES * (TB_BM + TB_BN) * TB_BK * 2 \
    + TB_BM * TB_BN * 2
SW_BM, SW_BN, SW_BK, SW_THREADS = 128, 128, 16, 256
SW_SMEM = 2 * SW_BK * (SW_BM + 4) * 4
ROWS_THREADS = 256                      # the row lists: one block an expert
GATHER_THREADS = 128    # the gathers: threads a block (a slot or token)
BWD_TILE_KEYS = ("bm", "bn", "bk", "stages", "smem", "wg_stages",
                 "wg_smem", "threads", "producer_regs", "consumer_regs",
                 "sw_bm", "sw_bn", "sw_bk", "sw_smem", "sw_threads",
                 "rows_threads")
# the bf16 products' tile queues (csrc: MODE_*, tc_tiles), in launch order
TC_PRODUCTS = ("dh", "dxin", "dwd", "dwg_dwu", "dcombine")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _split(chunks: int, blocks: int, target: int) -> tuple[int, int]:
    """(splits, chunks per split) of the down product's depth: at least
    ``target`` blocks where the depth allows, at most 8 splits."""
    ks = min(8, chunks, max(1, _cdiv(target, blocks)))
    per = _cdiv(chunks, ks)
    return _cdiv(chunks, per), per


def tc_stages(nt: int) -> int:
    """Ring depth of a tensor-core block with a slot tile of ``nt``: as
    many stages (at most 6) as fit 220 KB, one block an SM."""
    return min(6, (220 * 1024 - 1024) // (TC_WBYTES + nt * TC_K * 2))


def tc_smem(nt: int) -> int:
    """Dynamic shared-memory bytes of a tensor-core block: its ring on a
    1024-byte boundary (a slot's liveness flag, 4 bytes, is static)."""
    return 1024 + tc_stages(nt) * (TC_WBYTES + nt * TC_K * 2)


def plan(G: int, g: int, E: int, C: int, d: int, f: int,
         dtype: torch.dtype, n_sm: int) -> dict:
    """The kernels' tiles for one shape, a pure function of (G, g, E, C,
    d, f, dtype, n_sm), never of the data: a token's bits do not depend
    on which slots hold tokens.

    Returns ``tile`` (bf16: the slot tile, the narrowest of
    ``SLOT_TILES`` that holds C, or C split evenly into tiles of at most
    160; f32: slots per warp, 1/4/8), ``slots`` a block covers, the depth
    of a chunk ``depth``, the down product's split ``ks`` into parts of
    ``per`` chunks, and for each product (``up``, ``down``) its ``grid``
    (slot tiles fastest for bf16, so the blocks that share a weight tile
    run together), ``threads``, ring ``stages`` (0: the f32 kernels keep
    one chunk ahead in registers), shared memory ``smem`` (bf16: dynamic,
    as the source's ``moe_grouped_ffn_tiles`` gives it; f32: static) and
    ``resident`` blocks an SM by shared memory."""
    if dtype == torch.float32:
        rm = 1 if C <= 8 else 4 if C <= 32 else 8
        slots = WARPS * rm
        ct = _cdiv(C, slots)
        ks, per = _split(_cdiv(f, DK), _cdiv(d, COLS) * ct * G * E,
                         4 * n_sm)
        smem = {m: DK * (slots + 4) * 4 + m * DK * COLS * 4 + slots * 4
                for m in (1, 2)}
        kinds = {"up": (2, (_cdiv(f, COLS), ct, G * E)),
                 "down": (1, (_cdiv(d, COLS), ct, G * E * ks))}
        return dict(tile=rm, slots=slots, depth=DK, ks=ks, per=per, **{
            k: dict(grid=grid, threads=32 * WARPS, stages=0, smem=smem[m],
                    resident=SM_SMEM // (smem[m] + 1024), cols=COLS)
            for k, (m, grid) in kinds.items()})
    ct = _cdiv(C, SLOT_TILES[-1])
    nt = next(t for t in SLOT_TILES if t >= _cdiv(C, ct))
    ct = _cdiv(C, nt)
    resident = SM_SMEM // (tc_smem(nt) + nt * 4 + 1024)
    # split f until the down product has a block for every SM, two where
    # the slots are few (decode: its f32 partials are small, and the
    # experts without a token leave holes in the grid)
    ks, per = _split(_cdiv(f, TC_K), ct * _cdiv(d, TC_COLS["down"]) * G * E,
                     (2 if nt <= 32 else 1) * resident * n_sm)
    grids = {"up": (ct, _cdiv(f, TC_COLS["up"]), G * E),
             "down": (ct, _cdiv(d, TC_COLS["down"]), G * E * ks)}
    return dict(tile=nt, slots=nt, depth=TC_K, ks=ks, per=per, **{
        k: dict(grid=grid, threads=TC_THREADS, stages=tc_stages(nt),
                smem=tc_smem(nt), resident=resident, cols=TC_COLS[k])
        for k, grid in grids.items()})


def kernel_tiles() -> dict:
    """The built library's own numbers for the bf16 kernels, to hold
    :func:`plan` to: {(slot tile, product): (shared-memory bytes, stages,
    weight columns a block)}."""
    lib = _build.load(NAME, SIGNATURES)
    return {(nt, k): tuple(lib.moe_grouped_ffn_tiles(nt, int(k == "up"), w)
                           for w in range(3))
            for nt in SLOT_TILES for k in ("up", "down")}


def tc_queue(name: str, G: int, g: int, E: int, C: int, d: int,
             f: int) -> tuple[int, int, int]:
    """The tile queue (z, a, b) of a bf16 backward product, b fastest
    (csrc ``tc_tiles``): dh and dxin walk (expert, TB_BN columns of f or d,
    TB_BM listed rows of the expert's G C), dwd and dwg_dwu (expert,
    TB_BM rows of f or d, TB_BN columns of d or TB_BN / 2 of f of each of
    dwg and dwu), dcombine (group, TB_BN slots of E C, TB_BM tokens)."""
    return {"dh": (E, _cdiv(f, TB_BN), _cdiv(G * C, TB_BM)),
            "dxin": (E, _cdiv(d, TB_BN), _cdiv(G * C, TB_BM)),
            "dwd": (E, _cdiv(f, TB_BM), _cdiv(d, TB_BN)),
            "dwg_dwu": (E, _cdiv(d, TB_BM), _cdiv(f, TB_BN // 2)),
            "dcombine": (G, _cdiv(E * C, TB_BN), _cdiv(g, TB_BM))}[name]


def plan_bwd(G: int, g: int, E: int, C: int, d: int, f: int,
             dtype: torch.dtype, n_sm: int) -> dict:
    """The backward's launches for one shape, a pure function of (G, g,
    E, C, d, f, dtype, n_sm), never of the data.  Returns the product
    blocks' tiles (``route`` "wgmma": bf16, ``bm`` x ``bn`` outputs a
    tile, ``bk`` deep stages through a ring of ``stages`` and ``smem``
    dynamic bytes, the weight gradients' ``wg_stages`` and ``wg_smem``,
    ``threads`` of a producer and two consumer warpgroups with
    ``producer_regs`` / ``consumer_regs`` registers; "simt": f32 on the
    CUDA cores, static ``smem``), the CUDA-core block's (``sw``), and per
    launch its ``grid`` (x, y, z), ``threads``, ``smem`` and, for the
    persistent products, ring ``stages``: bf16's
    ``rows`` (one block an expert), ``dy`` (the combine-weighted gather of
    dout), the persistent products ``dh`` (dy wd^T with da, db in its
    epilogue), ``dxin`` ([da | db] [wg | wu]^T), ``dwd``, ``dwg_dwu`` and
    ``dcombine``, each with its tile ``queue`` (z, a, b) and ``tiles``,
    on min(tiles, n_sm) blocks, and ``dx`` (the dispatch gather); f32's
    ``dy``, ``dh``, ``dxin`` (twice: da wg^T, db wu^T), ``dwd``,
    ``dwg_dwu`` (twice), ``dx`` and ``dcombine`` on (columns, rows, z)
    grids.  ``launches`` counts them."""
    sw = dict(bm=SW_BM, bn=SW_BN, bk=SW_BK, smem=SW_SMEM, threads=SW_THREADS)
    grids = {"dy": ((C, E, G), GATHER_THREADS, 4 * _cdiv(g, 32)),
             "dx": ((g, G), GATHER_THREADS, 4 * _cdiv(E * C, 32))}
    if dtype == torch.bfloat16:
        tile = dict(route="wgmma", bm=TB_BM, bn=TB_BN, bk=TB_BK,
                    stages=TB_STAGES, smem=TB_SMEM, wg_stages=TB_WG_STAGES,
                    wg_smem=TB_WG_SMEM, threads=TB_THREADS,
                    producer_regs=TB_PRODUCER_REGS,
                    consumer_regs=TB_CONSUMER_REGS)
        out = {"rows": dict(grid=(E, 1, 1), threads=ROWS_THREADS, smem=36)}
        for name in TC_PRODUCTS:
            q = tc_queue(name, G, g, E, C, d, f)
            n = q[0] * q[1] * q[2]
            wg = name in ("dwd", "dwg_dwu")
            out[name] = dict(grid=(min(n, n_sm), 1, 1), threads=TB_THREADS,
                             smem=TB_WG_SMEM if wg else TB_SMEM,
                             stages=TB_WG_STAGES if wg else TB_STAGES,
                             queue=q, tiles=n)
        launches = 8
    else:
        tile = dict(route="simt", stages=1, **sw)
        bm, bn = SW_BM, SW_BN
        out = {k: dict(grid=grid, threads=SW_THREADS, smem=SW_SMEM)
               for k, grid in (
                   ("dh", (_cdiv(f, bn), _cdiv(C, bm), G * E)),
                   ("dxin", (_cdiv(d, bn), _cdiv(C, bm), G * E)),
                   ("dwd", (_cdiv(d, bn), _cdiv(f, bm), E)),
                   ("dwg_dwu", (_cdiv(f, bn), _cdiv(d, bm), E)),
                   ("dcombine", (_cdiv(E * C, bn), _cdiv(g, bm), G)))}
        launches = 9
    out.update({k: dict(grid=grid, threads=t, smem=sm)
                for k, (grid, t, sm) in grids.items()})
    return dict(tile=tile, sw=sw, launches=launches, **out)


def bwd_kernel_tiles() -> dict:
    """The built library's own numbers for the backward's blocks, to hold
    :func:`plan_bwd` and the constants here to: {BWD_TILE_KEYS: value}."""
    lib = _build.load(NAME, SIGNATURES)
    return {k: lib.moe_grouped_ffn_bwd_tiles(i)
            for i, k in enumerate(BWD_TILE_KEYS)}


def bwd_kernel_queues(G: int, g: int, E: int, C: int, d: int,
                      f: int) -> dict:
    """The built library's tile queues of the bf16 products at one shape,
    to hold :func:`tc_queue` to: {name: (z, a, b)}."""
    lib = _build.load(NAME, SIGNATURES)
    return {name: tuple(lib.moe_grouped_ffn_bwd_queue(i, G, g, E, C, d, f, w)
                        for w in (1, 2, 3))
            for i, name in enumerate(TC_PRODUCTS)}


def expert_rows(live: torch.Tensor) -> torch.Tensor:
    """The bf16 backward's row lists from the forward's slot liveness
    ``live`` (G, E, C) int32 -> (E G C + E + G E C) int32: at e G C..,
    the slots (group E + e) C + c of expert e in (group, slot) order, the
    ones with a token first and then the others; at E G C + e, the count
    of the first; at E G C + E + slot, the slot's place in its expert's
    list.  A CUDA tensor goes through the backward's first kernel, a CPU
    tensor through the plain version."""
    G, E, C = live.shape
    GC = G * C
    if live.device.type == "cuda":
        out = torch.empty(E * GC + E + G * E * C, dtype=torch.int32,
                          device=live.device)
        lib = _build.load(NAME, SIGNATURES)
        with torch.cuda.device(live.device):
            rc = lib.moe_grouped_ffn_rows(
                live.contiguous().data_ptr(), out.data_ptr(), G, E, C,
                torch.cuda.current_stream(live.device).cuda_stream)
        _build.check(lib, rc, f"{NAME}_rows")
        return out
    slots = torch.arange(G * E * C, dtype=torch.int32).view(G, E, C)
    on = live.cpu().transpose(0, 1).reshape(E, GC) != 0
    order = slots.transpose(0, 1).reshape(E, GC)
    lists = torch.cat([torch.cat([order[e][on[e]], order[e][~on[e]]])
                       for e in range(E)])
    place = torch.empty(G * E * C, dtype=torch.int32)
    place[lists.long()] = torch.arange(GC, dtype=torch.int32).repeat(E)
    return torch.cat([lists, on.sum(1, dtype=torch.int32), place])


def _check(ts: tuple) -> None:
    dispatch, combine, xg, wg, wu, wd = ts
    if xg.device.type != "cuda" or any(t.device != xg.device for t in ts):
        raise ValueError(f"{NAME}: CUDA tensors on one device only, got "
                         f"{sorted({str(t.device) for t in ts})}")
    if dispatch.dtype != torch.bool or combine.dtype != torch.float32:
        raise ValueError(f"{NAME}: dispatch must be bool and combine f32, "
                         f"got {dispatch.dtype} / {combine.dtype}")
    if xg.dtype not in ELEM or any(w.dtype != xg.dtype for w in ts[3:]):
        raise ValueError(f"{NAME}: dtypes {[str(t.dtype) for t in ts[2:]]}")
    if dispatch.ndim != 4 or xg.ndim != 3:
        raise ValueError(f"{NAME}: dispatch (G, g, E, C) and xg (G, g, d)")
    G, g, E, C = dispatch.shape
    d = xg.shape[-1]
    f = wg.shape[-1]
    if (combine.shape != dispatch.shape or xg.shape != (G, g, d)
            or wg.shape != (E, d, f) or wu.shape != (E, d, f)
            or wd.shape != (E, f, d)):
        raise ValueError(f"{NAME}: shapes {[tuple(t.shape) for t in ts]}")
    if d % 8 or f % 8:
        raise ValueError(f"{NAME}: d {d} and f {f} must be multiples of 8")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{NAME}: inputs must be contiguous and 16-byte "
                         "aligned")
    if max(G, E) > MAX_GRID:
        raise ValueError(f"{NAME}: {G} groups or {E} experts exceed the "
                         f"grid limit {MAX_GRID}")


def launch_forward(ts: tuple, save: bool
                   ) -> tuple[torch.Tensor, dict | None]:
    """The forward's launches on checked inputs ``ts`` (dispatch, combine,
    xg, wg, wu, wd); with ``save``, also what :func:`moe_grouped_ffn_bwd`
    reads: {xin, h, a, b (the up product's pre-activations), y (bf16: the
    down product's output (G, E, C, d), summed over the split and rounded
    once, 0 at dead slots; f32: its split partials), live, ks}."""
    dispatch, combine, xg, wg, wu, wd = ts
    G, g, E, C = dispatch.shape
    d, f = xg.shape[-1], wg.shape[-1]
    out = torch.empty((G, g, d), dtype=xg.dtype, device=xg.device)
    if out.numel() == 0 or C == 0:
        return out.zero_(), None
    p = plan(G, g, E, C, d, f, xg.dtype, torch.cuda.get_device_properties(
        xg.device).multi_processor_count)
    ks = p["ks"]
    if G * E * ks > MAX_GRID or max(p["up"]["grid"][1:]) > MAX_GRID:
        raise ValueError(f"{NAME}: {G} x {E} x {ks} exceeds the grid limit")
    xin = torch.empty((G, E, C, d), dtype=xg.dtype, device=xg.device)
    h = torch.empty((G, E, C, f), dtype=xg.dtype, device=xg.device)
    y = torch.empty((ks, G, E, C, d), dtype=torch.float32, device=xg.device)
    live = torch.empty((G, E, C), dtype=torch.int32, device=xg.device)
    a = torch.empty_like(h) if save else None
    b = torch.empty_like(h) if save else None
    bf16_y = torch.empty_like(xin) if save and xg.dtype == torch.bfloat16 \
        else None
    lib = _build.load(NAME, SIGNATURES)
    with torch.cuda.device(xg.device):
        rc = lib.moe_grouped_ffn_fwd(
            dispatch.data_ptr(), combine.data_ptr(), xg.data_ptr(),
            wg.data_ptr(), wu.data_ptr(), wd.data_ptr(), out.data_ptr(),
            xin.data_ptr(), h.data_ptr(), y.data_ptr(), live.data_ptr(),
            a.data_ptr() if save else None, b.data_ptr() if save else None,
            None if bf16_y is None else bf16_y.data_ptr(), ELEM[xg.dtype], G, g, E, C, d, f, p["tile"], p["up"]["stages"],
            ks, p["per"],
            torch.cuda.current_stream(xg.device).cuda_stream)
    _build.check(lib, rc, NAME)
    _build.count(NAME)
    return out, (dict(xin=xin, h=h, a=a, b=b,
                      y=y if bf16_y is None else bf16_y, live=live, ks=ks)
                 if save else None)


def moe_grouped_ffn(dispatch: torch.Tensor, combine: torch.Tensor,
                    xg: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                    wd: torch.Tensor) -> torch.Tensor:
    """dispatch: (G, g, E, C) bool; combine: (G, g, E, C) f32; xg: (G, g, d);
    wg/wu: (E, d, f); wd: (E, f, d), all CUDA tensors on one device, xg and
    the weights of one dtype (f32 or bf16), all contiguous at 16-byte
    aligned addresses, d and f multiples of 8 -> (G, g, d) in xg's
    dtype.  No gradient: :class:`MoEGroupedFFN` differentiates."""
    ts = (dispatch, combine, xg, wg, wu, wd)
    if any(t.requires_grad for t in ts) and torch.is_grad_enabled():
        raise ValueError(f"{NAME}: the raw wrapper records no gradient; "
                         "differentiate through MoEGroupedFFN.apply")
    _check(ts)
    return launch_forward(ts, save=False)[0]


def moe_grouped_ffn_bwd(dout: torch.Tensor, dispatch: torch.Tensor,
                        combine: torch.Tensor, wg: torch.Tensor,
                        wu: torch.Tensor, wd: torch.Tensor, saved: dict
                        ) -> tuple[torch.Tensor, ...]:
    """The gradient of :func:`moe_grouped_ffn` from dout (G, g, d) in x's
    dtype and the forward's ``saved`` tensors (``launch_forward(...,
    save=True)``) -> (dx (G, g, d), dcombine (G, g, E, C) f32, dwg, dwu (E, d, f), dwd
    (E, f, d)), the gradients in x's dtype.  One launch count."""
    G, g, E, C = dispatch.shape
    d, f = wg.shape[1], wg.shape[2]
    dt = wg.dtype
    if dout.shape != (G, g, d) or dout.dtype != dt or dout.device != \
            wg.device or not dout.is_contiguous() or dout.data_ptr() % 16:
        raise ValueError(f"{NAME}_bwd: dout {tuple(dout.shape)} {dout.dtype}"
                         f" on {dout.device}, want ({G}, {g}, {d}) {dt}, "
                         "contiguous and 16-byte aligned on the weights' "
                         "device")
    n_sm = torch.cuda.get_device_properties(wg.device).multi_processor_count
    p = plan_bwd(G, g, E, C, d, f, dt, n_sm)
    if any(max(v["grid"][1:]) > MAX_GRID or v.get("tiles", 0) >= 2 ** 31
           for v in p.values() if isinstance(v, dict) and "grid" in v):
        raise ValueError(f"{NAME}_bwd: a grid passes the limit {MAX_GRID}")
    dev = wg.device
    dx = torch.empty((G, g, d), dtype=dt, device=dev)
    dcomb = torch.empty((G, g, E, C), dtype=torch.float32, device=dev)
    dwg, dwu = torch.empty_like(wg), torch.empty_like(wu)
    dwd = torch.empty_like(wd)
    if saved is None:                   # C == 0 or no token: no FFN output
        return (dx.zero_(), dcomb.zero_(), dwg.zero_(), dwu.zero_(),
                dwd.zero_())
    # dy, da, db: f32 at the slots' rows (G, E, C, .); bf16 in list order
    # (E, G C, .), the rows of each expert's list
    rows_first = (G, E, C) if dt == torch.float32 else (E, G * C)
    dy = torch.empty(rows_first + (d,), dtype=dt, device=dev)
    da = torch.empty(rows_first + (f,), dtype=dt, device=dev)
    db = torch.empty_like(da)
    dxin = torch.empty((G, E, C, d), dtype=torch.float32, device=dev)
    rows = torch.empty(E * G * C + E + G * E * C, dtype=torch.int32,
                       device=dev) if dt == torch.bfloat16 else None
    sv = saved
    lib = _build.load(NAME, SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.moe_grouped_ffn_bwd(
            dispatch.data_ptr(), combine.data_ptr(), dout.data_ptr(),
            wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
            sv["xin"].data_ptr(), sv["h"].data_ptr(), sv["a"].data_ptr(),
            sv["b"].data_ptr(), sv["y"].data_ptr(), sv["live"].data_ptr(),
            dx.data_ptr(), dcomb.data_ptr(), dwg.data_ptr(), dwu.data_ptr(),
            dwd.data_ptr(), dy.data_ptr(), da.data_ptr(), db.data_ptr(),
            dxin.data_ptr(), None if rows is None else rows.data_ptr(),
            ELEM[dt], G, g, E, C, d, f, sv["ks"], n_sm,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, f"{NAME}_bwd")
    _build.count(f"{NAME}_bwd")
    return dx, dcomb, dwg, dwu, dwd


class MoEGroupedFFN(torch.autograd.Function):
    """The grouped FFN with its hand-written backward: ``apply(dispatch,
    combine, xg, wg, wu, wd)`` with :func:`moe_grouped_ffn`'s contract.

    When a gradient is wanted the forward keeps what the backward reads:
    xin (G, E, C, d) and H (G, E, C, f) in x's dtype (its own scratch),
    the up product's pre-activations a = xin wg and b = xin wu (G, E, C,
    f) in x's dtype, written by the same launch, and the down product's
    output y: bf16, (G, E, C, d), its f32 split partials summed and
    rounded once by one more launch (the plain version's own out_e, which
    dcombine = dout . y reads on the tensor cores); f32, the partials (ks,
    G, E, C, d).  Keeping a and b (2 x 147 MB in bf16 a layer at
    mixtral's training shape) costs less than the two products (a third
    of the backward's) that recomputing them would take, and y (42 MB in
    bf16) less than a third product; H is the forward's own bf16 H, so
    dwd = H^T dy sees the operand the forward multiplied.  Without a
    gradient (``torch.no_grad``, serving) the forward allocates and keeps
    nothing beyond :func:`moe_grouped_ffn`'s scratch.  The backward
    returns no gradient for dispatch, an f32 one for combine and x's
    dtype for x and the weights."""

    @staticmethod
    def forward(ctx, dispatch, combine, xg, wg, wu, wd):
        ts = (dispatch, combine, xg, wg, wu, wd)
        _check(ts)
        save = any(ctx.needs_input_grad)
        out, saved = launch_forward(ts, save)
        if save:
            ctx.save_for_backward(dispatch, combine, wg, wu, wd)
            ctx.saved = saved
        return out

    @staticmethod
    def backward(ctx, dout):
        dispatch, combine, wg, wu, wd = ctx.saved_tensors
        dx, dcomb, dwg, dwu, dwd = moe_grouped_ffn_bwd(
            dout.contiguous(), dispatch, combine, wg, wu, wd, ctx.saved)
        ctx.saved = None
        return None, dcomb, dx, dwg, dwu, dwd
