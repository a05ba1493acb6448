"""granite-moe-1b-a400m [moe] — 32 experts top-8
(hf:ibm-granite/granite-3.0-1b-a400m-base).

24L d_model=1024 16H (GQA kv=8) head_dim=64 d_ff(expert)=512
vocab=49155 (exact).
"""
from repro_torch.configs.common import reduce_for_smoke
from repro_torch.models.model import BlockSpec, ModelConfig

ARCH = "granite-moe-1b-a400m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        family="moe",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=8,
        head_dim=64,
        d_ff=0,
        vocab_size=49155,  # exact; embed shards on d_model only
        pattern=(BlockSpec("attn", "moe"),),
        num_experts=32,
        top_k=8,
        d_ff_expert=512,
        rope_theta=10_000.0,
        tie_embeddings=True,
        act="silu",
        train_microbatches=2,
    )


def smoke() -> ModelConfig:
    return reduce_for_smoke(config(), top_k=2)
