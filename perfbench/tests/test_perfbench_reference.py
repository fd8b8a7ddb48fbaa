"""The plain reference against the program on the CPU (plain versions,
float32): the model's loss and gradients, and the delta-stale AdamW steps
through the ParameterDB engine."""
import pytest
import torch

import tiny
from perfbench import compare, feed, harness
from perfbench.reference import model as ref_model

SEED = 2 ** 31 + 11


def test_loss_and_grads_match_lm_loss():
    from repro_torch.launch.steps import make_lm_grad_fn
    from repro_torch.core.sync import SyncConfig
    from repro_torch.models.transformer import model_specs
    conf = tiny.DENSE
    cfg = harness.program_config(conf)
    params = feed.make_params(model_specs(cfg), SEED, torch.device("cpu"))
    b = feed.make_batch(SEED, 0, 3, 32, conf["vocab_size"],
                        torch.device("cpu"))
    loss, grads = make_lm_grad_fn(cfg, SyncConfig(remat="none"))(params, b)
    want_loss, want = ref_model.loss_and_grads(
        params, b["tokens"], b["labels"], conf, ref_model.Numerics())
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-6)
    got = dict(feed.leaf_items(grads))
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("steps", [3, 5])
def test_reference_follows_the_engine(remat, steps):
    """Five steps at delta 2 read theta_0 three times, then theta_1 and
    theta_2 from the ring."""
    cell = tiny.cell(tiny.DENSE, checked_steps=steps, remat=remat)
    dev = torch.device("cpu")
    prog = harness.build_program(cell, SEED, dev)
    mine = harness.checked_steps(prog, cell, SEED, dev)
    theirs = harness.reference_readings(cell, SEED, dev)
    gaps = compare.gaps(mine, theirs)
    assert gaps["loss_gap"] < 1e-6
    assert gaps["grad_norm_gap"] < 1e-5
    assert gaps["change_norm_gap"] < 1e-5


def test_fresh_reads_are_not_the_reference():
    """The same steps read without delay (delta 0) differ from the
    reference's delta-2 steps: the comparison sees the stale read."""
    cell = tiny.cell(tiny.DENSE, checked_steps=5)
    sync_cell = tiny.cell(tiny.DENSE, checked_steps=5, delta=0)
    dev = torch.device("cpu")
    prog = harness.build_program(sync_cell, SEED, dev)
    mine = harness.checked_steps(prog, sync_cell, SEED, dev)
    theirs = harness.reference_readings(cell, SEED, dev)
    assert compare.gaps(mine, theirs)["loss_gap"] > 100 * \
        tiny.LIMITS["loss_gap"]
