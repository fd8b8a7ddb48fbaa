"""The dry run (``repro_torch.launch.dryrun``) of the vision config's smoke
config: its train cells (global batch 8 x 32) on fake (4, 2) ``data,
model`` and (2, 2, 2) ``pod, data, model`` meshes, in a subprocess of its
own (``tests/torch_mesh_harness.py``), as JAX's
``test_small_mesh_dryrun_subprocess``: ``bsp`` communicates by an
all-reduce, ``datacentric`` by a reduce-scatter and an all-gather; every
number is finite; the per-device argument bytes are those reckoned from
JAX's ``resolve_spec`` on the same mesh (parameters, AdamW's m and v, its
step, the batch, the media).  ``costmodel.group_body_cost``
counts one layer of each group standalone under the step's shardings,
every layer kind included.
"""
import json

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_mesh_harness as H  # noqa: E402

ARCHS = ["llama-3.2-vision-11b"]


@pytest.fixture(scope="module")
def dry():
    out = H.run_python(H.DRY_SNIPPET, json.dumps(ARCHS))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(H.DRY_MESHES))
@pytest.mark.parametrize("mode", ["bsp", "datacentric"])
def test_dry_run_train_cell(dry, arch, mesh, mode):
    H.check_dry_cell(dry[f"{arch}/{mesh}/{mode}"], arch, mesh, mode)


@pytest.mark.parametrize("arch", ARCHS)
def test_group_body_cost(dry, arch):
    """One layer of each group standalone under the step's shardings
    (``costmodel.group_body_cost``), its kinds included."""
    from repro_torch.configs import get_smoke_config
    H.check_group_bodies(dry[f"{arch}/body"],
                         len(get_smoke_config(arch).groups))
