"""Architecture registry (own copy of ``repro.configs``).

``get_config(arch_id)`` returns the full published config;
``get_smoke_config(arch_id)`` the reduced same-family variant the CPU tests
use.  The dense GQA and the MoE architectures are ported so far; asking
for any other known architecture raises ``KeyError`` naming the slice of
the port that brings it.
"""
from __future__ import annotations

import importlib

ARCHS = (
    "llama3_2_1b",
    "smollm_360m",
    "mixtral_8x7b",
    "llama4_scout_17b_16e",
)

# architectures of the JAX zoo that later slices of the port bring
PENDING = {
    "rwkv6_1_6b": "slice 5 (recurrent mixers: rwkv6_scan)",
    "recurrentgemma_2b": "slice 5 (recurrent mixers: rglru_scan)",
    "olmo_1b": "slice 6 (rest of the zoo: layernorm_np)",
    "gemma3_4b": "slice 6 (rest of the zoo: qk_norm, local layers, softcap)",
    "musicgen_large": "slice 6 (rest of the zoo: audio tokens)",
    "llama3_2_vision_11b": "slice 6 (rest of the zoo: xattn, vision)",
}

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
    if name in PENDING:
        raise KeyError(f"arch {arch!r} is not ported yet; it comes with "
                       f"{PENDING[name]}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str):
    return _module(arch).config()


def get_smoke_config(arch: str):
    return _module(arch).smoke_config()


def all_arch_ids() -> list[str]:
    """The ported architectures' public ids."""
    return [a for a, m in ALIASES.items() if m in ARCHS]
