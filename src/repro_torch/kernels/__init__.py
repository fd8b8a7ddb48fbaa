"""Kernels of the port: hand-written CUDA for Hopper (``csrc/``), their
plain PyTorch versions (``ref``) and the device-routed dispatch (``ops``).
Nothing here builds or imports a compiler at import time."""
