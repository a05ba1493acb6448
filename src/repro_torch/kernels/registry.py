"""Kernel <-> plain version registry of the port.

One entry per hand-written CUDA kernel: its wrapper
(``<module>.<function>``), its plain PyTorch version in ``ref``, the
CUDA source, and the JAX ``KERNEL_REFS`` key
(``src/repro/kernels/registry.py``) of the Pallas kernel it ports,
with that kernel's entry point. A backward kernel has no Pallas kernel
(the JAX package lets XLA differentiate): its ``jax_ref`` and
``replaces`` are ``None`` and ``backward_of`` names its forward. A
mode of a kernel that a path launches through a wrapper of its own,
with its own plain version and launch count, is listed under its
kernel's ``modes``: the same source and Pallas kernel. The parity
tests and ``chip_smoke.py`` iterate it, so a kernel cannot ship
without its plain version.

A plain literal: reading it imports nothing.
"""
from __future__ import annotations

KERNELS: dict[str, dict] = {
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
    "segmented_sum_count": {
        "wrapper": "seg_aggregate.segmented_sum_count",
        "plain": "segmented_sum_count",
        "source": "src/repro_torch/kernels/csrc/seg_aggregate.cu",
        "jax_ref": "seg_aggregate.segmented_sum_count",
        "replaces": "src/repro/kernels/seg_aggregate.py:125",
    },
    "flash_attention": {
        "wrapper": "flash_attention.flash_attention_bhsd",
        "plain": "flash_attention",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "jax_ref": "flash_attention.flash_attention_bhsd",
        "replaces": "src/repro/kernels/flash_attention.py:73",
    },
    "flash_attention_bwd": {
        "wrapper": "flash_attention.flash_attention_bwd_bhsd",
        "plain": "flash_attention_bwd",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "jax_ref": None,
        "replaces": None,
        "backward_of": "flash_attention",
    },
    "decode_attention": {
        "wrapper": "decode_attention.decode_attention_bhgd",
        "plain": "decode_attention",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "jax_ref": "decode_attention.decode_attention_bhgd",
        "replaces": "src/repro/kernels/decode_attention.py:70",
        # the split-K half that the JAX kernel's docstring describes for
        # a cache split over the mesh (decode_attention.py:10-13): each
        # rank's slice of the sequence to (o float32, lse), the partials
        # combined over the ranks (launch/fsdp.py's serve)
        "modes": {
            "decode_attention_partial": {
                "wrapper": "decode_attention.decode_attention_partial_bhgd",
                "plain": "decode_attention_partial",
            },
        },
    },
}

# JAX kernels with no CUDA kernel yet: none (every KERNEL_REFS key above)
NOT_PORTED: dict[str, str] = {}
