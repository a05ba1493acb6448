"""Segment aggregation kernel wrapper: ``csrc/seg_aggregate.cu`` on a
CUDA tensor.

Ports the Pallas TPU kernel ``src/repro/kernels/seg_aggregate.py``
(``segmented_aggregate`` and ``segmented_sum_count``). The kernels,
their design and their bound are described in the source; the plain
versions are ``ref.segmented_aggregate`` and ``ref.segmented_sum_count``.
No query path launches ``segmented_sum_count``: the legacy group-by
route calls its plain version, as the JAX executor calls its jnp twin;
``ops.segmented_sum_count`` is its entry point.

``plan_for`` fixes a launch from the shapes alone (grid, rows per CTA,
where the accumulator lives, the row list's size, the scratch); the
wrappers validate a call signature once and keep its plan; the
scratch is one buffer per stream.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

# (ptr[10], cfg[9], stream): see the entry points in csrc/seg_aggregate.cu
_ARGS = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
         ctypes.c_void_p]
_Ptrs = ctypes.c_void_p * 10

TILE_ROWS = 4096          # chunks are whole tiles (64 rows a thread)
LIST_CAP = 1024           # valid rows listed in shared memory at most
_THREADS = 256            # kThreads
_SMEM_BLOCK = 232448      # shared memory one block may use (H100)
_SMEM_SM = 233472         # shared memory of one SM
_STATIC_SMEM = 3072       # the kernel's static shared arrays, rounded up
_RESERVED_SMEM = 1024     # kept by the runtime for each resident block
_H100_SMS = 132


class Plan(NamedTuple):
    """One launch (pass 1 and the combine), from the shapes alone."""
    chunks: int            # CTAs per partition (grid x of pass 1)
    chunk_rows: int        # rows per CTA, a multiple of TILE_ROWS
    list_cap: int          # valid rows per shared-memory list pass
    smem_acc: bool         # accumulator in shared memory (else global)
    smem_bytes: int        # dynamic shared memory of pass 1
    ctas_per_sm: int       # resident CTAs of pass 1 on one SM
    width: int             # accumulator floats per CTA
    ctas: int              # P x chunks
    scratch_floats: int    # partials: ctas x width


def plan_for(p: int, n: int, s: int, nc: int, full: bool = True,
             sms: int = _H100_SMS, resident: int | None = None) -> Plan:
    """The launch for P partitions of N rows, S segments and C value
    columns (``full``: count/sum/min/max with ``ok`` flags, as
    ``segmented_aggregate``; else count/sum, as ``segmented_sum_count``).

    The accumulator, (1 + 3C) x S floats (sum/count: 2S), stays in
    shared memory when it fits beside a list of LIST_CAP rows; else it
    is the CTA's slot of the global partials and the list takes what
    a block may use. The grid is one resident wave of ``sms`` SMs (CTAs
    an SM holds: by shared memory and threads, and at most ``resident``,
    the card's own count for the kernel, registers included),
    split over the partitions in whole tiles (the kernel reads up to
    16384 rows a step, 64 a thread); a CTA with a global
    accumulator initialises all of it, so it gets at least as many
    rows as the accumulator has slots."""
    nstat = 3 if full else 1
    width = s * (1 + nstat * nc)
    row_bytes = 4 + 4 * nc + (nc if full else 0)
    acc_bytes = -(-4 * width // 16) * 16
    smem_acc = acc_bytes + LIST_CAP * row_bytes + _STATIC_SMEM <= _SMEM_BLOCK
    list_cap = LIST_CAP if smem_acc else min(
        LIST_CAP, (_SMEM_BLOCK - _STATIC_SMEM) // row_bytes)
    if list_cap < 32:
        raise ValueError(f"segmented_aggregate: C={nc} value columns do "
                         f"not fit the row list")
    smem = (acc_bytes if smem_acc else 0) + list_cap * row_bytes
    per_sm = max(1, min(2048 // _THREADS,
                        _SMEM_SM // (smem + _STATIC_SMEM + _RESERVED_SMEM),
                        resident or 2048))
    tiles = max(1, -(-n // TILE_ROWS))
    min_tiles = 1 if smem_acc else max(1, -(-width // TILE_ROWS))
    want = -(-sms * per_sm // max(p, 1))
    chunk_tiles = -(-tiles // max(1, min(want, tiles // min_tiles)))
    chunks = -(-tiles // chunk_tiles)
    return Plan(chunks, chunk_tiles * TILE_ROWS, list_cap, smem_acc, smem,
                per_sm, width, p * chunks, p * chunks * width)


class _Launch(NamedTuple):
    """What a validated call signature fixes, kept so that a call costs
    little host time."""
    plan: Plan
    cfg: ctypes.Array   # P, N, C, S, chunks, chunk_rows, list_cap,
                        # use_smem, device: as the entry points read it
    head: int           # scratch floats before the CTAs' int2 ranges
    need: int           # scratch floats in all


_launches: dict[tuple, _Launch] = {}
_MAX_LAUNCHES = 256
_sms: dict[int, int] = {}
# One scratch buffer per (device, stream), grown to the largest call's
# need: calls on one stream run in order and share it, so the kernels
# keep no more device memory than one call's partials. Layout: the
# partials, then the CTAs' int2 ranges.
_workspace: dict[tuple[int, int], torch.Tensor] = {}


def _launch_for(key: tuple, dev: torch.device, p: int, n: int, s: int,
                nc: int, full: bool) -> _Launch:
    idx = dev.index or 0
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    pl = plan_for(p, n, s, nc, full, _sms[idx])
    fn = _build.function("seg_aggregate", "repro_seg_resident",
                         [ctypes.c_int] * 4)
    got = fn(nc, int(full), pl.smem_bytes, idx)
    if got <= 0:
        raise RuntimeError(f"seg_aggregate: no pass-1 CTA fits an SM "
                           f"({pl.smem_bytes} bytes of shared memory, "
                           f"CUDA error {-got})")
    pl = plan_for(p, n, s, nc, full, _sms[idx], got)
    if len(_launches) >= _MAX_LAUNCHES:
        _launches.clear()
    head = pl.scratch_floats + (pl.scratch_floats & 1)   # 8-byte aligned
    lc = _launches[key] = _Launch(pl, (ctypes.c_int * 9)(
        p, n, nc, s, pl.chunks, pl.chunk_rows, pl.list_cap,
        int(pl.smem_acc), idx), head, head + 2 * pl.ctas)
    return lc


def _launch(symbol: str, kernel: str, lc: _Launch, dev: torch.device,
            ptrs: ctypes.Array) -> None:
    """Fill in the scratch addresses and run one entry point."""
    stream = _build.stream(dev)
    ws = _workspace.get((lc.cfg[8], stream))
    if ws is None or ws.numel() < lc.need:
        ws = _workspace[(lc.cfg[8], stream)] = torch.empty(
            lc.need, dtype=torch.float32, device=dev)
    base = ws.data_ptr()
    ptrs[4], ptrs[5] = base, base + 4 * lc.head
    fn = _build.function("seg_aggregate", symbol, _ARGS)
    _build.check("seg_aggregate", kernel, fn(ptrs, lc.cfg, stream))


def _check_agg(values, ok, segments, valid, s):
    dev = values.device
    if values.dim() != 3:
        raise ValueError("values must be [P, N, C]")
    p, n, nc = values.shape
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


def segmented_aggregate(values: torch.Tensor, ok: torch.Tensor,
                        segments: torch.Tensor, valid: torch.Tensor,
                        num_segments: int):
    """values [P, N, C] f32, ok [P, N, C] bool, segments [P, N] int32,
    valid [P, N] bool -> (counts [P, S], sums [P, S, C], mins [P, S, C],
    maxs [P, S, C]) float32. C may be 0. CUDA tensors only."""
    dev = values.device
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"segmented_aggregate kernel needs CUDA tensors, "
                         f"got {dev}")
    s = int(num_segments)
    if dev.type == "meta":      # shapes only (the dry run): no launch
        _check_agg(values, ok, segments, valid, s)
        p, _, nc = values.shape
        stats = torch.empty((3, p, s, nc), dtype=torch.float32, device=dev)
        return (torch.empty((p, s), dtype=torch.float32, device=dev),
                *stats.unbind(0))
    key = (values.shape, values.dtype, ok.shape, ok.dtype, segments.shape,
           segments.dtype, valid.shape, valid.dtype, dev, ok.device,
           segments.device, valid.device, s)
    lc = _launches.get(key)
    if lc is None:
        _check_agg(values, ok, segments, valid, s)
        p, n, nc = values.shape
        lc = _launch_for(key, dev, p, n, s, nc, True)
    p, n, nc = values.shape
    vals, okc = values.contiguous(), ok.contiguous()
    seg, vld = segments.contiguous(), valid.contiguous()
    counts = torch.empty((p, s), dtype=torch.float32, device=dev)
    stats = torch.empty((3, p, s, nc), dtype=torch.float32, device=dev)
    sp, step = stats.data_ptr(), 4 * p * s * nc
    _launch("repro_seg_agg", "segmented_aggregate", lc, dev, _Ptrs(
        vals.data_ptr(), okc.data_ptr(), seg.data_ptr(), vld.data_ptr(),
        None, None, counts.data_ptr(), sp, sp + step, sp + 2 * step))
    segmented_aggregate.launches += 1
    sums, mins, maxs = stats.unbind(0)
    return counts, sums, mins, maxs


segmented_aggregate.launches = 0


def segmented_sum_count(values: torch.Tensor, segments: torch.Tensor,
                        valid: torch.Tensor, num_segments: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """values [P, N] f32, segments [P, N] int32, valid [P, N] bool ->
    (sums [P, S], counts [P, S]) float32 over the valid rows whose
    segment id lies in [0, S). CUDA tensors only."""
    dev = values.device
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"segmented_sum_count kernel needs CUDA tensors, "
                         f"got {dev}")
    s = int(num_segments)
    key = ("sum_count", values.shape, values.dtype, segments.shape,
           segments.dtype, valid.shape, valid.dtype, dev, segments.device,
           valid.device, s)
    lc = _launches.get(key)
    if lc is None:
        if values.dim() != 2:
            raise ValueError("values must be [P, N]")
        p, n = values.shape
        if values.dtype != torch.float32 or segments.dtype != torch.int32 \
                or valid.dtype != torch.bool:
            raise ValueError("values float32, segments int32, valid bool")
        if tuple(segments.shape) != (p, n) or tuple(valid.shape) != (p, n):
            raise ValueError("values, segments and valid must all be [P, N]")
        if any(t.device != dev for t in (segments, valid)):
            raise ValueError("segmented_sum_count inputs on several devices")
        if s < 0 or n >= 2**31 or 2 * s >= 2**31:
            raise ValueError(f"segment space out of range (S={s})")
        if dev.type == "meta":  # shapes only (the dry run): no launch
            return tuple(torch.empty((2, p, s), dtype=torch.float32,
                                     device=dev).unbind(0))
        lc = _launch_for(key, dev, p, n, s, 1, False)
    p, n = values.shape
    vals, seg, vld = values.contiguous(), segments.contiguous(), \
        valid.contiguous()
    out = torch.empty((2, p, s), dtype=torch.float32, device=dev)
    op = out.data_ptr()
    _launch("repro_seg_sum_count", "segmented_sum_count", lc, dev, _Ptrs(
        vals.data_ptr(), None, seg.data_ptr(), vld.data_ptr(), None, None,
        op + 4 * p * s, op, None, None))
    segmented_sum_count.launches += 1
    sums, counts = out.unbind(0)
    return sums, counts


segmented_sum_count.launches = 0
