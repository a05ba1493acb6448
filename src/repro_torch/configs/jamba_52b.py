"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2
(arXiv:2403.19887).

32L d_model=4096 32H (GQA kv=8) head_dim=128 d_ff=14336 vocab=65536.
Period of 8: attention at position 4, mamba elsewhere; MoE MLP at odd
positions, dense MLP at even (Jamba's e=2 MoE period). No rotary
positions (Jamba relies on Mamba for position information).
"""
from repro_torch.configs.common import reduce_for_smoke
from repro_torch.models.model import BlockSpec, ModelConfig

ARCH = "jamba-v0.1-52b"


def _pattern():
    spec = []
    for i in range(8):
        mixer = "attn" if i == 4 else "mamba"
        mlp = "moe" if i % 2 == 1 else "dense"
        spec.append(BlockSpec(mixer, mlp))
    return tuple(spec)


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        family="hybrid",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=65536,
        pattern=_pattern(),
        use_rope=False,
        num_experts=16,
        top_k=2,
        d_ff_expert=14336,
        ssm_state=16,
        ssm_conv=4,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_chunk=256,
        tie_embeddings=True,
        act="silu",
        train_microbatches=8,
    )


def smoke() -> ModelConfig:
    return reduce_for_smoke(config())
