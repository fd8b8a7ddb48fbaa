"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8 experts top-2, sliding-window attention (4096).
[arXiv:2401.04088; hf]"""
import dataclasses

from repro_torch.models.config import BlockGroup, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", family="moe",
        groups=(BlockGroup(("swa",), 32),),
        d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
        vocab_size=32000, head_dim=128, window=4096,
        rope_theta=1_000_000.0, norm="rmsnorm", mlp="swiglu",
        tie_embeddings=False,
        n_experts=8, top_k=2, capacity_factor=1.25,
        max_seq=32_768, long_context=True,     # SWA bounds the KV cache
        source="arXiv:2401.04088")


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), groups=(BlockGroup(("swa",), 2),),
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, head_dim=16,
        vocab_size=256, window=16, n_experts=4, top_k=2,
        moe_group_size=64, max_seq=128)
