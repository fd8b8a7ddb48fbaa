"""olmo-1b [dense]: 16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304.
Non-parametric LayerNorm.  [arXiv:2402.00838; hf]"""
import dataclasses

from repro_torch.models.config import BlockGroup, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b", family="dense",
        groups=(BlockGroup(("attn",), 16),),
        d_model=2048, n_heads=16, n_kv_heads=16, d_ff=8192,
        vocab_size=50304, rope_theta=10_000.0,
        norm="layernorm_np",            # the OLMo signature choice
        mlp="swiglu", tie_embeddings=True,
        max_seq=4096, source="arXiv:2402.00838")


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), groups=(BlockGroup(("attn",), 2),),
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256, max_seq=128)
