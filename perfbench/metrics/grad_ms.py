"""The model's forward and backward, device time a step: what the engine's
``grad_fn`` launched (``launch/steps.make_lm_grad_fn`` -> ``models/*``,
the kernels under them)."""
from ._spans import span_ms_per_step


def read(run):
    return span_ms_per_step(run, "perfbench.grad_fn")
