"""Architecture registry (own copy of ``repro.configs``).

``get_config(arch_id)`` returns the full published config;
``get_smoke_config(arch_id)`` the reduced same-family variant the CPU tests
use.  Every architecture of the JAX package's zoo is here; an unknown id
raises ``KeyError``.
"""
from __future__ import annotations

import importlib

ARCHS = (
    "llama3_2_1b",
    "smollm_360m",
    "mixtral_8x7b",
    "llama4_scout_17b_16e",
    "rwkv6_1_6b",
    "recurrentgemma_2b",
    "olmo_1b",
    "gemma3_4b",
    "musicgen_large",
    "llama3_2_vision_11b",
)

# public --arch ids (hyphenated) -> module names
ALIASES = {
    "llama3.2-1b": "llama3_2_1b",
    "smollm-360m": "smollm_360m",
    "olmo-1b": "olmo_1b",
    "gemma3-4b": "gemma3_4b",
    "musicgen-large": "musicgen_large",
    "mixtral-8x7b": "mixtral_8x7b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_16e",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "llama-3.2-vision-11b": "llama3_2_vision_11b",
    "recurrentgemma-2b": "recurrentgemma_2b",
}


def _module(arch: str):
    name = ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    if name not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str):
    return _module(arch).config()


def get_smoke_config(arch: str):
    return _module(arch).smoke_config()


def all_arch_ids() -> list[str]:
    """The public ids of every architecture."""
    return list(ALIASES)
