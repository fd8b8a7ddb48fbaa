"""Core of the port (own copies of ``repro.core``'s modules):

  history    — formal operation-history model + Theorem 1-3 checkers
  scheduler  — the policies of repro_torch.pdb under their old names
  simulator  — discrete-event makespan simulation (Fig 2 reproduction)
  threaded   — live multi-threaded linear regression (Sec 6) over the
               blocking ParameterDB, on the card or the CPU
  staleness  — the device ring buffer of repro_torch.pdb.torch_backend
               under its old name
  sync       — the synchronization configuration (``SyncConfig``)
"""
from .sync import SyncConfig  # noqa: F401
