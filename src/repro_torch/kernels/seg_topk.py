"""Segment top-k kernel wrapper: ``csrc/seg_topk.cu`` on a CUDA tensor.

Ports the Pallas TPU kernel ``src/repro/kernels/seg_topk.py``
(``segment_topk``). The kernel, its design and its bound are described
in the source; the plain version is ``ref.segment_topk``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_uint] \
    + [ctypes.c_int] * 2 + [ctypes.c_void_p]
MAX_KEYS = 32     # one bit of the float mask per key row


def segment_topk(keys: tuple[torch.Tensor, ...], cap: int) -> torch.Tensor:
    """keys: tuple of [P, N] — keys[0] the int32 invalid-sink flag,
    then int32 or float32 sort keys (most significant first, NaN-free,
    descending ones negated) -> [P, cap] int32: the first ``cap`` rows
    of the stable ascending lexicographic order. CUDA tensors only."""
    dev = keys[0].device
    if dev.type != "cuda":
        raise ValueError(f"segment_topk kernel needs CUDA tensors, got {dev}")
    p, n = keys[0].shape
    if not 0 < cap <= n:
        raise ValueError(f"need 0 < cap <= N (cap={cap}, N={n})")
    if len(keys) > MAX_KEYS or keys[0].dtype != torch.int32:
        raise ValueError("keys[0] must be the int32 flag; at most "
                         f"{MAX_KEYS} key rows")
    mask = 0
    rows = []
    for i, k in enumerate(keys):
        if tuple(k.shape) != (p, n) or k.device != dev:
            raise ValueError(f"key {i} must be [P, N] on {dev}")
        if k.dtype == torch.float32:
            mask |= 1 << i
            rows.append(k.contiguous().view(torch.int32))
        elif k.dtype == torch.int32:
            rows.append(k)
        else:
            raise ValueError(f"key {i}: int32 or float32, got {k.dtype}")
    raw = torch.stack(rows)                          # [nkeys, P, N]
    scratch = torch.empty((p, len(keys), n), dtype=torch.int32, device=dev)
    out = torch.empty((p, cap), dtype=torch.int32, device=dev)
    fn = _build.function("seg_topk", "repro_segment_topk", _ARGS)
    code = fn(raw.data_ptr(), scratch.data_ptr(), out.data_ptr(), p, n,
              len(keys), mask, cap, dev.index or 0,
              torch.cuda.current_stream(dev).cuda_stream)
    _build.check("seg_topk", "segment_topk", code)
    segment_topk.launches += 1
    return out


segment_topk.launches = 0
