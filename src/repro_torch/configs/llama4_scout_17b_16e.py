"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
import dataclasses

from repro_torch.models.config import BlockGroup, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e", family="moe",
        groups=(BlockGroup(("attn",), 48),),
        d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
        vocab_size=202048, head_dim=128, rope_theta=500_000.0,
        norm="rmsnorm", mlp="swiglu", tie_embeddings=False,
        n_experts=16, top_k=1, capacity_factor=1.25,
        max_seq=131_072, source="hf:meta-llama/Llama-4-Scout-17B-16E")


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), groups=(BlockGroup(("attn",), 2),),
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, head_dim=16,
        vocab_size=256, n_experts=4, top_k=1, moe_group_size=64,
        max_seq=128)
