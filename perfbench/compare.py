"""The comparison that decides ``correct``: the program's checked steps
against the reference's.

Three numbers, each against the cell's limit (``limits/<cell>.json``):

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_norm_gap``: over the leaves, the largest gap between the
  program's and the reference's norm of the first gradient (as AdamW
  received it, clipped), over the reference's norm of that leaf or of the
  median leaf, whichever is larger;
* ``change_norm_gap``: the same of each leaf's change over the checked
  steps, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (they move under Adam by round-off
  alone).
"""
from __future__ import annotations

import statistics

NEGLIGIBLE = 1e-3          # a leaf's gradient over the median leaf's


def loss_gap(mine, theirs) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(mine.losses,
                                                   theirs.losses))


def norm_gap(mine: dict, theirs: dict, leaves) -> tuple[float, str]:
    """(the worst leaf's gap, that leaf)."""
    med = statistics.median(theirs[k] for k in leaves)
    return max((abs(mine[k] - theirs[k]) / max(theirs[k], med), k)
               for k in leaves)


def counted_leaves(theirs) -> list[str]:
    g = theirs.first_grad_norms
    med = statistics.median(g.values())
    return sorted(k for k, v in g.items() if v >= NEGLIGIBLE * med)


def gaps(mine, theirs) -> dict:
    if set(mine.first_grad_norms) != set(theirs.first_grad_norms):
        raise ValueError("program and reference have different leaves: "
                         f"{sorted(mine.first_grad_norms)} against "
                         f"{sorted(theirs.first_grad_norms)}")
    grad, grad_leaf = norm_gap(mine.first_grad_norms,
                               theirs.first_grad_norms,
                               sorted(theirs.first_grad_norms))
    change, change_leaf = norm_gap(mine.change_norms, theirs.change_norms,
                                   counted_leaves(theirs))
    return {"loss_gap": loss_gap(mine, theirs), "grad_norm_gap": grad,
            "grad_norm_leaf": grad_leaf, "change_norm_gap": change,
            "change_norm_leaf": change_leaf}


def leaf_gaps(mine, theirs) -> dict:
    """Each leaf's (first gradient, change) gaps, as ``gaps`` measures
    them: the look behind a worst leaf."""
    gm = statistics.median(theirs.first_grad_norms.values())
    cm = statistics.median(theirs.change_norms[k]
                           for k in counted_leaves(theirs))
    return {k: (abs(mine.first_grad_norms[k] - g) / max(g, gm),
                abs(mine.change_norms[k] - theirs.change_norms[k])
                / max(theirs.change_norms[k], cm))
            for k, g in theirs.first_grad_norms.items()}


NUMBERS = ("loss_gap", "grad_norm_gap", "change_norm_gap")


def checks(mine, theirs, limits: dict) -> dict:
    """{number: {"value", "limit"}} of the numbers the cell's limits
    name."""
    g = gaps(mine, theirs)
    return {k: {"value": g[k], "limit": limits[k]}
            for k in NUMBERS if k in limits}
