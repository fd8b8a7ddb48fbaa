"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000.  RG-LRU + local attention, 1 attention : 2 recurrent.
[arXiv:2402.19427; hf]"""
import dataclasses

from repro_torch.models.config import BlockGroup, ModelConfig

_PAT = ("rglru", "rglru", "local")


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid",
        # 26 layers = 8 x (rglru, rglru, local) + 2 rglru tail
        groups=(BlockGroup(_PAT, 8), BlockGroup(("rglru", "rglru"), 1)),
        d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
        vocab_size=256000, head_dim=256, window=2048,
        rope_theta=10_000.0, norm="rmsnorm", mlp="geglu",
        tie_embeddings=True, embed_scale=True,
        d_rnn=2560, conv_width=4,
        max_seq=1_048_576, source="arXiv:2402.19427")


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), groups=(BlockGroup(_PAT, 1),),
        d_model=64, n_heads=4, n_kv_heads=1, d_ff=96, head_dim=16,
        vocab_size=256, window=16, d_rnn=64, max_seq=128)
