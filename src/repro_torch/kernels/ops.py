"""Executor-facing kernel entry points.

Each entry point launches its CUDA kernel when its tensors lie on a
CUDA device and runs the kernel's plain PyTorch version (``ref``) when
they lie on the CPU — the only reason it takes the plain version. A
kernel that fails to build or launch raises; nothing falls back.

The JAX package's ``ops`` chose among Pallas, the Pallas interpreter
and jnp twins by backend, with a dense/scatter size split
(``SEG_DENSE_NSEG_MAX``) measured on the CPU. Here the aggregate
kernel takes any segment count, so there is no size split.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import hash_join as _hj
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import seg_aggregate as _seg
from repro_torch.kernels import seg_topk as _stk


def hash_join_probe(build_keys, build_valid, probe_keys, probe_valid):
    """Same results as ``executor.hash_join_probe``: (pos, matched,
    bucket overflow [P]). The probe is exact (no hashing), so there is
    no bucket and the overflow flag is always False."""
    if build_valid.is_cuda:
        pos, matched = _hj.block_join_probe(tuple(build_keys), build_valid,
                                            tuple(probe_keys), probe_valid)
    else:
        pos, matched = _ref.block_join_probe(tuple(build_keys), build_valid,
                                             tuple(probe_keys), probe_valid)
    return pos, matched, torch.zeros(probe_valid.shape[0], dtype=torch.bool,
                                     device=probe_valid.device)


def segmented_aggregate(values, ok, segments, valid, num_segments: int):
    """Fused segment aggregation (the group-by entry point):
    values/ok [P, N, C] (C >= 0), segments/valid [P, N] -> counts
    [P, S], sums/mins/maxs [P, S, C]. With C == 0 only counts are
    computed."""
    fn = _seg.segmented_aggregate if values.is_cuda \
        else _ref.segmented_aggregate
    return fn(values, ok, segments, valid, num_segments)


def segment_topk(keys, cap: int):
    """Stable top-k selection (the ORDER BY / LIMIT entry point):
    keys[0] the invalid-sink flag, then the sort keys most significant
    first (descending ones negated), each [P, N] -> idx [P, cap]."""
    fn = _stk.segment_topk if keys[0].is_cuda else _ref.segment_topk
    return fn(tuple(keys), cap)
