"""smollm-360m [dense]: 32L d_model=960 15H (GQA kv=5) d_ff=2560
vocab=49152.  [hf:HuggingFaceTB/SmolLM-135M; hf]"""
import dataclasses

from repro_torch.models.config import BlockGroup, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m", family="dense",
        groups=(BlockGroup(("attn",), 32),),
        d_model=960, n_heads=15, n_kv_heads=5, d_ff=2560,
        vocab_size=49152, head_dim=64, rope_theta=10_000.0,
        norm="rmsnorm", mlp="swiglu", tie_embeddings=True,
        max_seq=32_768, source="hf:HuggingFaceTB/SmolLM-360M")


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), groups=(BlockGroup(("attn",), 2),),
        d_model=60, n_heads=3, n_kv_heads=1, d_ff=96, head_dim=20,
        vocab_size=256, max_seq=128)
