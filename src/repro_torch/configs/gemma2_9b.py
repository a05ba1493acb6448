"""gemma2-9b [dense] — local+global alternating, logit softcaps
(arXiv:2408.00118). 42L d_model=3584 16H (GQA kv=8) head_dim=256
d_ff=14336 vocab=256000.
"""
from repro_torch.configs.common import reduce_for_smoke
from repro_torch.models.model import BlockSpec, ModelConfig

ARCH = "gemma2-9b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        family="dense",
        num_layers=42,
        d_model=3584,
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        vocab_size=256000,
        pattern=(BlockSpec("attn_local", "dense"),
                 BlockSpec("attn", "dense")),
        window=4096,
        rope_theta=10_000.0,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        use_post_norm=True,
        embed_scale=True,
        tie_embeddings=True,
        act="gelu",
        train_microbatches=8,
    )


def smoke() -> ModelConfig:
    return reduce_for_smoke(config())
