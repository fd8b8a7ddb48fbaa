"""The WKV kernels' share of their roofline (``rwkv6_scan`` and its
backward; their work from ``kinds/mix_rwkv6.py``)."""
from ._roofline import share


def read(run):
    return share(run, ("rwkv6_scan", "rwkv6_scan_bwd"))
