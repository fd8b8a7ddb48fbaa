"""Sliding-window attention (``local``): ``mix_attn`` with the window."""
from .mix_attn import apply  # noqa: F401
