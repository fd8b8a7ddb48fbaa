"""The stale read, device time a step: part ``pdb.read_stale``
(``pdb/torch_backend.read_stale``: ``ring_gather`` and the unpack)."""
from ._spans import part_ms_per_step


def read(run):
    return part_ms_per_step(run, "pdb.read_stale")
