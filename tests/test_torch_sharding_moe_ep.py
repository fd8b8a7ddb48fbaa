"""The MoE expert-parallel hook (``REPRO_MOE_EP_CONSTRAINT=1``, JAX's
``models/moe.py:91-101``) on the port's sharded route:

* a 16-expert variant of the llama4-scout smoke config on 4 CPU ranks
  over gloo (a (2, 2) ``data, model`` mesh; ``tests/torch_mesh_harness.py``)
  at f32, batch 4 x 64, with the hook set in both processes and unset:
  the ``datacentric`` train step (AdamW at lr 3e-4), prefill and decode
  logits against JAX's under the same setting (JAX's runs under a
  one-device mesh, where its constraint changes no value);

The hook's layout in the dry run is ``test_torch_dryrun_ep.py``'s.
"""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_mesh_harness as H  # noqa: E402

S, L = 64, 80
EP = {"REPRO_MOE_EP_CONSTRAINT": "1"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jobs, want = {}, {}
    for name, env in (("ep_on", EP), ("ep_off", None)):
        jobs[name], want[name] = H.make_job(
            "llama4-scout-17b-a16e", S=S, L=L, env=env, n_experts=16,
            modes=("datacentric",))
    got = H.run_ranks(tmp_path_factory.mktemp("ep_mesh"), jobs)
    return want, got


@pytest.mark.parametrize("hook", ["ep_on", "ep_off"])
def test_ep_hook_matches_jax(runs, hook):
    want, got = runs
    H.check_train(want[hook], got[hook], "datacentric")
    H.check_serve(want[hook], got[hook])
