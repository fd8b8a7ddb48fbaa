"""The optimizer's device time a step: what ``opt.update`` launched
(``optim/optimizers.py``)."""
from ._spans import span_ms_per_step


def read(run):
    return span_ms_per_step(run, "perfbench.opt_update")
