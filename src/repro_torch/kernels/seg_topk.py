"""Segment top-k kernel wrapper: ``csrc/seg_topk.cu`` on a CUDA tensor.

Ports the Pallas TPU kernel ``src/repro/kernels/seg_topk.py``
(``segment_topk``). The kernel, its design and its bound are described
in the source; the plain version is ``ref.segment_topk``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint] + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
MAX_KEYS = 32     # one bit of the float mask per key row
SORT_SMEM = 128 * 1024   # shared memory for one chunk's records
MAX_CHUNK = 8192


@functools.cache
def _max_chunk(nkeys: int) -> int:
    """The largest power of two of records (the nkeys words and the row
    position, rounded up to whole 16-byte vectors) in SORT_SMEM, at most
    MAX_CHUNK."""
    fit = SORT_SMEM // (16 * ((nkeys + 4) // 4))
    return min(MAX_CHUNK, 1 << (fit.bit_length() - 1))


def chunk_rows(n: int, nkeys: int) -> int:
    """Rows one CTA sorts in shared memory: a power of two, at least 2,
    no more than N needs and at most ``_max_chunk(nkeys)``."""
    return min(_max_chunk(nkeys), 1 << max(1, (n - 1).bit_length()))


def segment_topk(keys: tuple[torch.Tensor, ...], cap: int) -> torch.Tensor:
    """keys: tuple of [P, N] — keys[0] the int32 invalid-sink flag,
    then int32 or float32 sort keys (most significant first, NaN-free,
    descending ones negated) -> [P, cap] int32: the first ``cap`` rows
    of the stable ascending lexicographic order. CUDA tensors only.
    Key rows are read in place (a row with a column stride other than 1
    is made contiguous first)."""
    k0 = keys[0]
    dev = k0.device
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"segment_topk kernel needs CUDA tensors, got {dev}")
    shape = k0.shape
    p, n = shape
    if not 0 < cap <= n:
        raise ValueError(f"need 0 < cap <= N (cap={cap}, N={n})")
    nkeys = len(keys)
    if nkeys > MAX_KEYS or k0.dtype != torch.int32:
        raise ValueError("keys[0] must be the int32 flag; at most "
                         f"{MAX_KEYS} key rows")
    mask = 0
    rows = []
    for i, k in enumerate(keys):
        if k.shape != shape or k.device != dev:
            raise ValueError(f"key {i} must be [P, N] on {dev}")
        if k.dtype == torch.float32:
            mask |= 1 << i
        elif k.dtype != torch.int32:
            raise ValueError(f"key {i}: int32 or float32, got {k.dtype}")
        rows.append(k if k.stride(1) == 1 else k.contiguous())
    # the key rows' pointers, then their partition strides
    args = (ctypes.c_longlong * (2 * nkeys))(
        *[r.data_ptr() for r in rows], *[r.stride(0) for r in rows])
    chunk = chunk_rows(n, nkeys)
    out = torch.empty((p, cap), dtype=torch.int32, device=dev)
    # sorted runs of the merge, only when N spans several chunks
    runs = torch.empty((2, p, n), dtype=torch.int32, device=dev) \
        if n > chunk else None
    if dev.type == "meta":      # shapes only (the dry run): no launch
        return out
    fn = _build.function("seg_topk", "repro_segment_topk", _ARGS)
    code = fn(ctypes.addressof(args), nkeys, mask, p, n, cap, chunk,
              out.data_ptr(), runs.data_ptr() if runs is not None else None,
              dev.index or 0, _build.stream(dev))
    _build.check("seg_topk", "segment_topk", code)
    segment_topk.launches += 1
    return out


segment_topk.launches = 0
