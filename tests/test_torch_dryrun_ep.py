"""The MoE expert-parallel hook (``REPRO_MOE_EP_CONSTRAINT=1``, JAX's
``models/moe.py:91-101``) in the dry run: a 16-expert variant of the
llama4-scout smoke config, train cell 4 x 64 on a fake (2, 2) ``data,
model`` mesh, in a subprocess of its own.  With the hook on, the plain
route's dispatched intermediates (E, G, C, d) of every layer are laid
out E/2 x G/2 a device; with it off the hook is not called.
"""
import json

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_mesh_harness as H  # noqa: E402

EP_SNIPPET = """
import dataclasses, json, os
from repro_torch.configs import get_smoke_config
from repro_torch.core.sync import SyncConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.shapes import ShapeCell
from repro_torch.models import moe

seen = []
hook = moe._ep_hook


def spy(cfg):
    ep = hook(cfg)
    if ep is None:
        return None

    def wrapped(t):
        t = ep(t)
        seen.append([list(t.shape), list(t.to_local().shape)])
        return t
    return wrapped


moe._ep_hook = spy
dryrun.fake_world(4)
cfg = dataclasses.replace(get_smoke_config("llama4-scout-17b-a16e"),
                          n_experts=16)
out = {}
for on in (True, False):
    if on:
        os.environ["REPRO_MOE_EP_CONSTRAINT"] = "1"
    else:
        os.environ.pop("REPRO_MOE_EP_CONSTRAINT")
    seen.clear()
    r = dryrun.measure_cell(cfg, ShapeCell("t", 64, 4, "train"),
                            make_test_mesh((2, 2)), SyncConfig())
    out[str(on)] = {"seen": list(seen), "status": r["status"]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def dry():
    out = H.run_python(EP_SNIPPET)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("on", [True, False])
def test_ep_hook_lays_out_dispatch_in_dry_run(dry, on):
    r = dry[str(on)]
    assert r["status"] == "ok"
    if not on:
        assert r["seen"] == []
        return
    # xin and out_e (E, G, C, d) of both layers, forward and remat's
    assert len(r["seen"]) == 2 * 2 * 2, r["seen"]
    for full, local in r["seen"]:
        E, G = full[:2]
        assert (E, G) == (16, 4)
        assert local == [E // 2, G // 2] + full[2:], (full, local)
