"""musicgen-large [audio]: 48L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=2048.  Decoder-only over EnCodec tokens.  [arXiv:2306.05284; hf]

Frontend stub: the EnCodec tokenizer is out of scope — input_specs()
provides precomputed codebook token ids (single interleaved stream,
vocab 2048), per the assignment's backbone-only rule."""
import dataclasses

from repro_torch.models.config import BlockGroup, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large", family="audio",
        groups=(BlockGroup(("attn",), 48),),
        d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
        vocab_size=2048, rope_theta=10_000.0,
        norm="layernorm", mlp="gelu", tie_embeddings=False,
        frontend="audio_tokens",
        max_seq=32_768, source="arXiv:2306.05284")


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), groups=(BlockGroup(("attn",), 2),),
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=128, max_seq=128)
