"""qwen3-1.7b [dense] — qk_norm, GQA (hf:Qwen/Qwen3-8B family).

28L d_model=2048 16H (GQA kv=8) head_dim=128 d_ff=6144 vocab=151936.
"""
from repro_torch.configs.common import reduce_for_smoke
from repro_torch.models.model import BlockSpec, ModelConfig

ARCH = "qwen3-1.7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        family="dense",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=6144,
        vocab_size=151936,
        pattern=(BlockSpec("attn", "dense"),),
        rope_theta=1_000_000.0,
        qk_norm=True,
        tie_embeddings=True,
        act="silu",
        train_microbatches=2,
    )


def smoke() -> ModelConfig:
    return reduce_for_smoke(config())
