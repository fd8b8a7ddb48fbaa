"""Model configuration shared by all architectures in the zoo.

Own copy of ``repro.models.config`` with torch dtypes in place of
``jnp.bfloat16`` / ``jnp.float32``.  A model is a list of **block
groups**; each group repeats a pattern of layer kinds ``n`` times over
stacked ``(n, ...)`` parameters (the port loops over the stack where JAX
scans).  Layer kinds:

  attn    — global causal self-attention (GQA)
  local   — sliding-window causal self-attention (bounded KV)
  swa     — alias of local (mixtral-style sliding window)
  xattn   — cross-attention to modality tokens (vision frontend stub)
  rwkv6   — RWKV-6 token-shift + data-dependent-decay WKV mixer
  rglru   — Griffin RG-LRU recurrent block (conv1d + gated linear recurrence)

Only the dense self-attention kinds run in the port so far; the others
raise ``NotImplementedError`` where a model is built.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

ATTN_KINDS = ("attn", "local", "swa", "xattn")
RECURRENT_KINDS = ("rwkv6", "rglru")


@dataclasses.dataclass(frozen=True)
class BlockGroup:
    pattern: tuple[str, ...]   # layer kinds within one stacked super-block
    n: int                     # number of pattern repetitions


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    groups: tuple[BlockGroup, ...]
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None       # default d_model // n_heads
    window: int = 0                   # sliding window for local/swa kinds
    rope_theta: float = 10_000.0
    rope_theta_global: float | None = None   # gemma3: distinct global theta
    norm: str = "rmsnorm"             # rmsnorm | layernorm | layernorm_np
    qk_norm: bool = False             # gemma3-style per-head q/k rmsnorm
    mlp: str = "swiglu"               # swiglu | geglu | gelu
    tie_embeddings: bool = True
    embed_scale: bool = False         # gemma: scale embeddings by sqrt(d)
    logit_softcap: float = 0.0
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 1024        # dispatch group size (tokens)
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3
    # --- recurrent (rwkv6 / rglru) ---
    d_rnn: int = 0                    # rglru recurrence width (default d_model)
    conv_width: int = 4               # rglru temporal conv width
    decay_lora: int = 64              # rwkv6 data-dependent decay rank
    # --- modality frontend stubs ---
    frontend: str | None = None       # None | "vision" | "audio_tokens"
    n_frontend_tokens: int = 0        # e.g. vision patch count
    d_frontend: int = 0               # raw patch embedding width
    # --- numerics ---
    dtype: Any = torch.bfloat16       # compute dtype
    param_dtype: Any = torch.float32  # master copy
    max_seq: int = 8192
    # --- shape-cell policy ---
    long_context: bool | None = None
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        out: list[str] = []
        for g in self.groups:
            out.extend(g.pattern * g.n)
        return tuple(out)

    def kv_cache_len(self, kind: str, seq_len: int) -> int:
        """Per-layer KV length needed to decode with ``seq_len`` context."""
        if kind in ("local", "swa"):
            return min(self.window, seq_len) if self.window else seq_len
        return seq_len

    def validate(self) -> None:
        if not (self.d_model % self.n_heads == 0 or self.head_dim):
            raise ValueError(f"{self.name}: d_model % n_heads != 0")
        if self.n_heads % self.n_kv_heads != 0:
            raise ValueError(f"{self.name}: n_heads % n_kv_heads != 0")
        if self.is_moe and not 0 < self.top_k <= self.n_experts:
            raise ValueError(f"{self.name}: bad top_k")
        for g in self.groups:
            for k in g.pattern:
                if k not in ATTN_KINDS + RECURRENT_KINDS:
                    raise ValueError(f"{self.name}: unknown kind {k!r}")
                if k in ("local", "swa") and self.window <= 0:
                    raise ValueError(f"{self.name}: {k} needs a window")
        if self.frontend == "vision" and not (
                self.n_frontend_tokens > 0 and self.d_frontend > 0):
            raise ValueError(f"{self.name}: vision frontend sizes")
