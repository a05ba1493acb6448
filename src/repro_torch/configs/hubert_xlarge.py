"""hubert-xlarge [audio] — encoder-only transformer (arXiv:2106.07447).

48L d_model=1280 16H (MHA kv=16) head_dim=80 d_ff=5120 vocab=504 (HuBERT cluster-code targets). The waveform conv frontend is a
STUB: input_specs() provides precomputed 512-dim frame embeddings, which
the model projects into d_model. Bidirectional attention; no decode step.
"""
from repro_torch.configs.common import reduce_for_smoke
from repro_torch.models.model import BlockSpec, ModelConfig

ARCH = "hubert-xlarge"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        family="audio",
        num_layers=48,
        d_model=1280,
        num_heads=16,
        num_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        vocab_size=504,  # exact; tiny cluster-code vocab
        pattern=(BlockSpec("attn", "dense"),),
        causal=False,
        use_rope=False,
        frontend="frames",
        frontend_dim=512,
        tie_embeddings=False,
        act="gelu",
        train_microbatches=4,
    )


def smoke() -> ModelConfig:
    return reduce_for_smoke(config(), num_kv_heads=4)
