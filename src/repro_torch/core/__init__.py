"""Core of the port: the Op-history oracle (``history``) and the
synchronization configuration (``sync``), own copies of ``repro.core``'s."""
from .sync import SyncConfig  # noqa: F401
