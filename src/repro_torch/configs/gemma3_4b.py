"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144.  5:1 local:global attention, 128k context, qk-norm,
distinct RoPE theta for local (10k) vs global (1M) layers.
[hf:google/gemma-3-1b-pt; unverified]

Long-context note: global layers keep a full KV cache, but decode memory is
bounded after kv_seq sequence-parallel sharding — long_500k is exercised
(DESIGN.md §5)."""
import dataclasses

from repro_torch.models.config import BlockGroup, ModelConfig

_PAT = ("local", "local", "local", "local", "local", "attn")


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b", family="dense",
        # 34 layers = 5 x (5 local + 1 global) + 4 local tail
        groups=(BlockGroup(_PAT, 5), BlockGroup(("local",) * 4, 1)),
        d_model=2560, n_heads=8, n_kv_heads=4, d_ff=10240,
        vocab_size=262144, head_dim=256, window=1024,
        rope_theta=10_000.0, rope_theta_global=1_000_000.0,
        norm="rmsnorm", qk_norm=True, mlp="geglu",
        tie_embeddings=True, embed_scale=True,
        max_seq=131_072, long_context=True,
        source="hf:google/gemma-3-4b-pt")


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), groups=(BlockGroup(_PAT, 1),),
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, head_dim=16,
        vocab_size=256, window=16, max_seq=128)
