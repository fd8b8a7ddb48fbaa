"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256.  Cross-attention image layers (every 5th layer).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

Frontend stub: the ViT tower is out of scope — input_specs() provides
precomputed patch embeddings (B, 1600, 1280); the model owns the projection
into d_model and the gated cross-attention layers."""
import dataclasses

from repro_torch.models.config import BlockGroup, ModelConfig

_PAT = ("attn", "attn", "attn", "attn", "xattn")


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b", family="vlm",
        groups=(BlockGroup(_PAT, 8),),   # 40 layers, xattn every 5th
        d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
        vocab_size=128256, head_dim=128, rope_theta=500_000.0,
        norm="rmsnorm", mlp="swiglu", tie_embeddings=False,
        frontend="vision", n_frontend_tokens=1600, d_frontend=1280,
        max_seq=131_072, source="hf:meta-llama/Llama-3.2-11B-Vision")


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), groups=(BlockGroup(_PAT, 1),),
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, head_dim=16,
        vocab_size=256, n_frontend_tokens=8, d_frontend=24, max_seq=128)
