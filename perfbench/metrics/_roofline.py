"""A counted kernel's share of its roofline, for any kernel a part's
description names (``kinds/``): the sum of the traced launches' bounds
over the device time of the operations whose names hold the kernel's
device name.  Each launch's work is its part's at the cell's shapes; the
launches the program counted (``_build.launches``) are spread evenly over
the layers whose part launches the kernel.  A new kernel's metric is

    def read(run):
        return share(run, ("<kernel>", "<kernel>_bwd"))
"""
from __future__ import annotations

from perfbench import counts, kinds


def share(run, kernels) -> float | None:
    """Percent of the roofline of the launches of ``kernels`` (names of
    ``_build.launches``), or None where none was launched or traced."""
    bound, names = 0.0, set()
    for k in kernels:
        work = [w for desc in kinds.parts(run.cfg)
                if (w := desc.kernels(run.cfg, run.traffic).get(k))]
        n = run.launches.get(k, 0)
        if work and n:
            names.update(w.device_name for w in work)
            bound += n / len(work) * sum(
                counts.bound_s(w.nbytes, w.flops, w.dtype) for w in work)
    us = sum(op.dur_us for op in run.trace.ops
             if any(name in op.name for name in names))
    if not bound or not us:
        return None
    return 100.0 * bound / (us / 1e6)
