"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution (arXiv:2409.12191).

28L d_model=1536 12H (GQA kv=2) head_dim=128 d_ff=8960 vocab=151936.
The vision tower is a STUB: input_specs() provides precomputed 1280-dim
patch embeddings (merger output dim), projected into the backbone; M-RoPE
positions (t/h/w) are supplied as a (3, B, S) input.
"""
from repro_torch.configs.common import reduce_for_smoke
from repro_torch.models.model import BlockSpec, ModelConfig

ARCH = "qwen2-vl-2b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        family="vlm",
        num_layers=28,
        d_model=1536,
        num_heads=12,
        num_kv_heads=2,
        head_dim=128,
        d_ff=8960,
        vocab_size=151936,
        pattern=(BlockSpec("attn", "dense"),),
        rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24),
        frontend="patches",
        frontend_dim=1280,
        tie_embeddings=True,
        act="silu",
        train_microbatches=2,
    )


def smoke() -> ModelConfig:
    return reduce_for_smoke(config())
