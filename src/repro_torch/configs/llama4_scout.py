"""llama4-scout-17b-a16e [moe] — MoE 16e top-1 + shared expert, early
fusion (hf:meta-llama/Llama-4-Scout-17B-16E).

48L d_model=5120 40H (GQA kv=8) head_dim=128 d_ff(expert)=8192
vocab=202048.
"""
from repro_torch.configs.common import reduce_for_smoke
from repro_torch.models.model import BlockSpec, ModelConfig

ARCH = "llama4-scout-17b-a16e"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        family="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=0,
        vocab_size=202048,
        pattern=(BlockSpec("attn", "moe"),),
        num_experts=16,
        top_k=1,
        d_ff_expert=8192,
        num_shared_experts=1,
        rope_theta=500_000.0,
        tie_embeddings=False,
        act="silu",
        train_microbatches=8,
    )


def smoke() -> ModelConfig:
    return reduce_for_smoke(config(), top_k=1)
