"""The ParameterDB engine's own device time a step (``pdb/torch_backend``:
the ring commit, the stale read, the step's bookkeeping): what the step
launched outside the gradient and optimizer spans."""
from ._spans import span_ms_per_step


def read(run):
    return span_ms_per_step(run, "perfbench.step")
