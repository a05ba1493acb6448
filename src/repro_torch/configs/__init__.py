"""Architecture registry, ported from ``repro/configs``: ``--arch <id>``
resolves through REGISTRY. The config modules are pure data, copied with
their imports renamed."""
from __future__ import annotations

from repro_torch.configs import (gemma2_9b, gemma3_12b, granite_moe_1b,
                                 hubert_xlarge, jamba_52b, llama3_8b,
                                 llama4_scout, mamba2_370m, qwen2_vl_2b,
                                 qwen3_1_7b)
from repro_torch.configs.common import (SHAPES, SKIPS, input_specs,
                                       supported)

_MODULES = [mamba2_370m, gemma3_12b, gemma2_9b, llama3_8b, qwen3_1_7b,
            jamba_52b, granite_moe_1b, llama4_scout, hubert_xlarge,
            qwen2_vl_2b]

REGISTRY = {m.ARCH: m.config for m in _MODULES}
SMOKE_REGISTRY = {m.ARCH: m.smoke for m in _MODULES}

ARCHS = tuple(REGISTRY)


def get_config(arch: str):
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[arch]()


def get_smoke_config(arch: str):
    return SMOKE_REGISTRY[arch]()
