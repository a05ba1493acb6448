"""mamba2-370m [ssm] — SSD (state-space duality), arXiv:2405.21060.

48L d_model=1024, attn-free (d_ff=0), vocab=50280, ssm_state=128.
"""
from repro_torch.configs.common import reduce_for_smoke
from repro_torch.models.model import BlockSpec, ModelConfig

ARCH = "mamba2-370m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        family="ssm",
        num_layers=48,
        d_model=1024,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=50280,  # exact; embed shards on d_model only
        pattern=(BlockSpec("mamba", "none"),),
        ssm_state=128,
        ssm_conv=4,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_chunk=256,
        tie_embeddings=True,
        act="silu",
        train_microbatches=2,
    )


def smoke() -> ModelConfig:
    return reduce_for_smoke(config(), num_heads=0, num_kv_heads=0,
                            head_dim=0, d_ff=0)
