"""Segment aggregation kernel wrapper: ``csrc/seg_aggregate.cu`` on a
CUDA tensor.

Ports the Pallas TPU kernel ``src/repro/kernels/seg_aggregate.py``
(``segmented_aggregate`` and ``segmented_sum_count``). The kernels,
their design and their bound are described in the source; the plain
versions are ``ref.segmented_aggregate`` and ``ref.segmented_sum_count``.
No query path launches ``segmented_sum_count``: the legacy group-by
route calls its plain version, as the JAX executor calls its jnp twin;
``ops.segmented_sum_count`` is its entry point.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_SUM_COUNT_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# CTAs per partition target: about two waves over the H100's 132 SMs
_TARGET_CTAS = 264
_ROWS_PER_CTA_MIN = 1024


def chunks_for(p: int, n: int) -> int:
    """CTAs per partition of the partial pass (>= 1)."""
    by_rows = max(1, -(-n // _ROWS_PER_CTA_MIN))
    return max(1, min(-(-_TARGET_CTAS // max(p, 1)), by_rows))


def segmented_aggregate(values: torch.Tensor, ok: torch.Tensor,
                        segments: torch.Tensor, valid: torch.Tensor,
                        num_segments: int):
    """values [P, N, C] f32, ok [P, N, C] bool, segments [P, N] int32,
    valid [P, N] bool -> (counts [P, S], sums [P, S, C], mins [P, S, C],
    maxs [P, S, C]) float32. C may be 0. CUDA tensors only."""
    dev = values.device
    if dev.type != "cuda":
        raise ValueError(f"segmented_aggregate kernel needs CUDA tensors, "
                         f"got {dev}")
    p, n, nc = values.shape
    s = int(num_segments)
    if values.dtype != torch.float32 or ok.dtype != torch.bool \
            or tuple(ok.shape) != (p, n, nc):
        raise ValueError("values must be float32 and ok bool, both [P, N, C]")
    if segments.dtype != torch.int32 or valid.dtype != torch.bool \
            or tuple(segments.shape) != (p, n) \
            or tuple(valid.shape) != (p, n):
        raise ValueError("segments must be int32 and valid bool, both [P, N]")
    if any(t.device != dev for t in (ok, segments, valid)):
        raise ValueError("segmented_aggregate inputs on several devices")
    if s < 0 or n >= 2**31 or s * (1 + 3 * nc) >= 2**31:
        raise ValueError(f"segment space out of range (S={s}, C={nc})")
    vals, okc = values.contiguous(), ok.contiguous()
    seg, vld = segments.contiguous(), valid.contiguous()
    chunks = chunks_for(p, n)
    partials = torch.empty(p * chunks * s * (1 + 3 * nc),
                           dtype=torch.float32, device=dev)
    counts = torch.empty((p, s), dtype=torch.float32, device=dev)
    sums = torch.empty((p, s, nc), dtype=torch.float32, device=dev)
    mins = torch.empty((p, s, nc), dtype=torch.float32, device=dev)
    maxs = torch.empty((p, s, nc), dtype=torch.float32, device=dev)
    fn = _build.function("seg_aggregate", "repro_seg_agg", _ARGS)
    code = fn(vals.data_ptr(), okc.data_ptr(), seg.data_ptr(),
              vld.data_ptr(), partials.data_ptr(), counts.data_ptr(),
              sums.data_ptr(), mins.data_ptr(), maxs.data_ptr(),
              p, n, nc, s, chunks, dev.index or 0,
              _build.stream(dev))
    _build.check("seg_aggregate", "segmented_aggregate", code)
    segmented_aggregate.launches += 1
    return counts, sums, mins, maxs


segmented_aggregate.launches = 0


def segmented_sum_count(values: torch.Tensor, segments: torch.Tensor,
                        valid: torch.Tensor, num_segments: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """values [P, N] f32, segments [P, N] int32, valid [P, N] bool ->
    (sums [P, S], counts [P, S]) float32 over the valid rows whose
    segment id lies in [0, S). CUDA tensors only."""
    dev = values.device
    if dev.type != "cuda":
        raise ValueError(f"segmented_sum_count kernel needs CUDA tensors, "
                         f"got {dev}")
    if values.dim() != 2:
        raise ValueError("values must be [P, N]")
    p, n = values.shape
    s = int(num_segments)
    if values.dtype != torch.float32 or segments.dtype != torch.int32 \
            or valid.dtype != torch.bool:
        raise ValueError("values float32, segments int32, valid bool")
    if tuple(segments.shape) != (p, n) or tuple(valid.shape) != (p, n):
        raise ValueError("values, segments and valid must all be [P, N]")
    if any(t.device != dev for t in (segments, valid)):
        raise ValueError("segmented_sum_count inputs on several devices")
    if s < 0 or n >= 2**31 or 2 * s >= 2**31:
        raise ValueError(f"segment space out of range (S={s})")
    vals, seg, vld = values.contiguous(), segments.contiguous(), \
        valid.contiguous()
    chunks = chunks_for(p, n)
    partials = torch.empty(p * chunks * 2 * s, dtype=torch.float32,
                           device=dev)
    sums = torch.empty((p, s), dtype=torch.float32, device=dev)
    counts = torch.empty((p, s), dtype=torch.float32, device=dev)
    fn = _build.function("seg_aggregate", "repro_seg_sum_count",
                         _SUM_COUNT_ARGS)
    code = fn(vals.data_ptr(), seg.data_ptr(), vld.data_ptr(),
              partials.data_ptr(), sums.data_ptr(), counts.data_ptr(),
              p, n, s, chunks, dev.index or 0,
              _build.stream(dev))
    _build.check("seg_aggregate", "segmented_sum_count", code)
    segmented_sum_count.launches += 1
    return sums, counts


segmented_sum_count.launches = 0
