"""The benchmark of the PyTorch and CUDA port (``repro_torch``); its entry
is ``perfbench/run.py``."""
