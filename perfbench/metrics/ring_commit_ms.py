"""The ring's commit, device time a step: part ``pdb.commit_ring``
(``pdb/torch_backend.commit_ring``: the pack and the ``index_copy_`` into
the ring)."""
from ._spans import part_ms_per_step


def read(run):
    return part_ms_per_step(run, "pdb.commit_ring")
