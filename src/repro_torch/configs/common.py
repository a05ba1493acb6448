"""Shared helpers for architecture configs, ported from
``repro/configs/common.py``: the shape cells, the documented skips and
the smoke-size reduction. ``input_specs`` (``jax.ShapeDtypeStruct``
stand-ins for the dry run) waits for the tooling item (ROADMAP.md, open
item 8).

  train_4k     seq=4096   gb=256  (training)
  prefill_32k  seq=32768  gb=32   (inference prefill)
  decode_32k   seq=32768  gb=128  (decode: 1 new token vs full KV)
  long_500k    seq=524288 gb=1    (long-context decode; sub-quadratic only)
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.model import ModelConfig

SHAPES: dict[str, dict] = {
    "train_4k": {"seq": 4096, "batch": 256, "kind": "train"},
    "prefill_32k": {"seq": 32768, "batch": 32, "kind": "prefill"},
    "decode_32k": {"seq": 32768, "batch": 128, "kind": "decode"},
    "long_500k": {"seq": 524288, "batch": 1, "kind": "decode"},
}

# Documented skips, with reasons.
SKIPS: dict[tuple[str, str], str] = {
    ("llama3-8b", "long_500k"): "pure full attention (quadratic)",
    ("qwen3-1.7b", "long_500k"): "pure full attention (quadratic)",
    ("granite-moe-1b-a400m", "long_500k"): "pure full attention (quadratic)",
    ("llama4-scout-17b-a16e", "long_500k"): "pure full attention (quadratic)",
    ("qwen2-vl-2b", "long_500k"): "pure full attention (quadratic)",
    ("hubert-xlarge", "decode_32k"): "encoder-only: no decode step",
    ("hubert-xlarge", "long_500k"): "encoder-only: no decode step",
}


def supported(arch: str, shape: str) -> bool:
    return (arch, shape) not in SKIPS


def reduce_for_smoke(cfg: ModelConfig, **over) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests."""
    nl = cfg.period * 2
    changes = dict(
        num_layers=nl,
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2),
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=128,
        window=8 if cfg.window else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=8 if cfg.ssm_state else 256,
        num_experts=4 if cfg.num_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        d_ff_expert=32 if cfg.d_ff_expert else 0,
        frontend_dim=24 if cfg.frontend_dim else 0,
        mrope_sections=(2, 3, 3) if cfg.mrope_sections else (),
        attn_chunk=16,
        ce_chunks=2,
        remat=False,
    )
    changes.update(over)
    return dataclasses.replace(cfg, **changes)
