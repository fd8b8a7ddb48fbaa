"""The dry run's stand-in for the two recurrences
(``costmodel.scan_standin``) against ``CostMode``'s count of the plain
loops it stands for, exactly: FLOPs, bytes and the storage left live
after the forward (outputs and what the backward keeps), then the
backward's FLOPs and bytes, for the WKV and the RG-LRU at 8 and 16 steps
in f32 and bf16, and their stateful forms' forwards.

The recurrent configs' sharded steps are ``test_torch_sharding_rwkv6.py``'s
and ``test_torch_sharding_recurrentgemma.py``'s, their dry-run cells
``test_torch_dryrun_zoo_{rwkv6,recurrentgemma}.py``'s.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.costmodel import CostMode, scan_standin  # noqa: E402


def _count(fn, args, grad):
    """(forward FLOPs, bytes, storage left live beside the inputs[,
    backward FLOPs, bytes]) of ``fn(*args)`` under ``CostMode``."""
    args = [a.detach().requires_grad_() if grad and a.is_floating_point()
            else a for a in args]
    mode = CostMode()
    held = mode.hold(args)
    with torch.set_grad_enabled(grad), mode:
        out = fn(*args)
    r = (mode.flops, mode.bytes, mode.live - held)
    if not grad:
        return r
    y = out[0] if isinstance(out, tuple) else out
    back = CostMode()
    with back:
        torch.autograd.grad(y, [a for a in args if a.requires_grad],
                            torch.ones_like(y))
    return r + (back.flops, back.bytes)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _scan_args(kind, T, dtype):
    Bn, Hn, hd = 2, 3, 8
    if kind == "rwkv6":
        x = [_meta(Bn, T, Hn, hd, dtype=dtype) for _ in range(3)]
        return ref.rwkv6, (*x, _meta(Bn, T, Hn, hd), _meta(Hn, hd)), 4
    if kind == "rwkv6_stateful":
        x = [_meta(Bn, T, Hn, hd, dtype=dtype) for _ in range(3)]
        return ref.rwkv6_stateful, (*x, _meta(Bn, T, Hn, hd),
                                    _meta(Hn, hd), _meta(Bn, Hn, hd, hd)), 4
    if kind == "rglru":
        return ops._rglru_plain, (_meta(Bn, T, 40, dtype=dtype),
                                  _meta(Bn, T, 40, dtype=dtype)), 2
    return ref.rglru, (_meta(Bn, T, 40, dtype=dtype),
                       _meta(Bn, T, 40, dtype=dtype), _meta(Bn, 40)), 2


@pytest.mark.parametrize("T", [8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["rwkv6", "rglru", "rwkv6_stateful",
                                  "rglru_stateful"])
def test_scan_standin_counts_the_plain_loop(kind, dtype, T):
    plain, args, n_seq = _scan_args(kind, T, dtype)
    grad = not kind.endswith("stateful")
    want = _count(plain, args, grad)
    got = _count(lambda *a: scan_standin(plain, a, n_seq), args, grad)
    assert got == want
    assert want[0] > 0 or kind.startswith("rglru")
