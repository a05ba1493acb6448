"""gemma3-12b [dense] — 5:1 local:global interleave, 128k context.

48L d_model=3840 16H (GQA kv=8) head_dim=256 d_ff=15360 vocab=262144.
"""
from repro_torch.configs.common import reduce_for_smoke
from repro_torch.models.model import BlockSpec, ModelConfig

ARCH = "gemma3-12b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        family="dense",
        num_layers=48,
        d_model=3840,
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,
        d_ff=15360,
        vocab_size=262144,
        pattern=(BlockSpec("attn_local", "dense"),) * 5
                + (BlockSpec("attn", "dense"),),
        window=1024,
        rope_theta=1_000_000.0,
        local_rope_theta=10_000.0,
        qk_norm=True,
        use_post_norm=True,
        embed_scale=True,
        tie_embeddings=True,
        act="gelu",
        train_microbatches=8,
    )


def smoke() -> ModelConfig:
    return reduce_for_smoke(config())
