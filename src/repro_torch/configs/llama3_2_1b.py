"""llama3.2-1b [dense]: 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256.  [hf:meta-llama/Llama-3.2-1B; unverified]"""
import dataclasses

from repro_torch.models.config import BlockGroup, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b", family="dense",
        groups=(BlockGroup(("attn",), 16),),
        d_model=2048, n_heads=32, n_kv_heads=8, d_ff=8192,
        vocab_size=128256, head_dim=64, rope_theta=500_000.0,
        norm="rmsnorm", mlp="swiglu", tie_embeddings=True,
        max_seq=131_072, source="hf:meta-llama/Llama-3.2-1B")


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), groups=(BlockGroup(("attn",), 2),),
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, head_dim=16,
        vocab_size=256, max_seq=128)
