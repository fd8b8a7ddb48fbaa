"""rwkv6-1.6b [ssm]: 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536, 32 heads of 64, decay LoRA 64.  [arXiv:2404.05892]

``config()`` is the JAX package's block (``mix_lora`` 0): its token
shifts are static ``sigmoid(mu)`` lerps, its decay LoRA has no tanh and
its output norm is a per-head RMS norm, departures from the paper.
Finch as published (data-dependent token shift of rank 32, tanh decay
LoRA, per-head GroupNorm) is ``dataclasses.replace(config(),
mix_lora=32)``; ``models/rwkv6.py`` gives both.
Finch's ``ln0`` on the embedding is in neither form."""
import dataclasses

from repro_torch.models.config import BlockGroup, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b", family="ssm",
        groups=(BlockGroup(("rwkv6",), 24),),
        d_model=2048, n_heads=32, n_kv_heads=32, d_ff=7168,
        vocab_size=65536, head_dim=64, decay_lora=64,
        norm="layernorm", tie_embeddings=False,
        max_seq=1_048_576,              # O(1) state: unbounded context
        source="arXiv:2404.05892")


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), groups=(BlockGroup(("rwkv6",), 2),),
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, head_dim=16,
        vocab_size=256, decay_lora=8, max_seq=128)
