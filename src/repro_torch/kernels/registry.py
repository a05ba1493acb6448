"""Kernel <-> plain version registry of the port.

One entry per hand-written CUDA kernel: its wrapper
(``<module>.<function>``), its plain PyTorch version in ``ref``, the
CUDA source, and the JAX ``KERNEL_REFS`` key
(``src/repro/kernels/registry.py``) of the Pallas kernel it ports,
with that kernel's entry point. The parity tests and ``chip_smoke.py``
iterate it, so a kernel cannot ship without its plain version.

A plain literal: reading it imports nothing.
"""
from __future__ import annotations

KERNELS: dict[str, dict[str, str]] = {
    "block_join_probe": {
        "wrapper": "hash_join.block_join_probe",
        "plain": "block_join_probe",
        "source": "src/repro_torch/kernels/csrc/hash_join.cu",
        "jax_ref": "hash_join.block_join_probe",
        "replaces": "src/repro/kernels/hash_join.py:56",
    },
    "segmented_aggregate": {
        "wrapper": "seg_aggregate.segmented_aggregate",
        "plain": "segmented_aggregate",
        "source": "src/repro_torch/kernels/csrc/seg_aggregate.cu",
        "jax_ref": "seg_aggregate.segmented_aggregate",
        "replaces": "src/repro/kernels/seg_aggregate.py:80",
    },
    "segment_topk": {
        "wrapper": "seg_topk.segment_topk",
        "plain": "segment_topk",
        "source": "src/repro_torch/kernels/csrc/seg_topk.cu",
        "jax_ref": "seg_topk.segment_topk",
        "replaces": "src/repro/kernels/seg_topk.py:69",
    },
}

# JAX kernels with no CUDA kernel yet (ROADMAP.md, "TPU kernels to port")
NOT_PORTED: dict[str, str] = {
    "seg_aggregate.segmented_sum_count":
        "src/repro/kernels/seg_aggregate.py:125",
    "flash_attention.flash_attention_bhsd":
        "src/repro/kernels/flash_attention.py:73",
    "decode_attention.decode_attention_bhgd":
        "src/repro/kernels/decode_attention.py:70",
}
