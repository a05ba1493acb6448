"""llama3-8b [dense] — GQA, 128k vocab (arXiv:2407.21783).

32L d_model=4096 32H (GQA kv=8) head_dim=128 d_ff=14336 vocab=128256.
"""
from repro_torch.configs.common import reduce_for_smoke
from repro_torch.models.model import BlockSpec, ModelConfig

ARCH = "llama3-8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=128256,
        pattern=(BlockSpec("attn", "dense"),),
        rope_theta=500_000.0,
        tie_embeddings=False,
        act="silu",
        train_microbatches=8,
    )


def smoke() -> ModelConfig:
    return reduce_for_smoke(config())
