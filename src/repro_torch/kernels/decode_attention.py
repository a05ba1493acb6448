"""Decode-attention kernel wrapper: ``csrc/decode_attention.cu`` on
CUDA tensors.

Ports the Pallas TPU kernel ``src/repro/kernels/decode_attention.py``
(``decode_attention_bhgd``). The kernel, its design and its bound are
described in the source; the plain version is ``ref.decode_attention``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import _DTYPES, as_bhsd, check_strided

_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_void_p]
_TILE_BYTES = 8192      # one K (or V) tile in shared memory (kTileBytes)
_MAX_TILE = 64          # slots per tile at most (kMaxTile)
_TARGET_CTAS = 396      # about three CTAs on each of the H100's 132 SMs
# D * element size the kernel takes
ROW_BYTES = (32, 64, 128, 256, 512, 1024)


class _Plan(NamedTuple):
    """What a call signature (shapes, strides, dtypes, devices, options)
    fixes: validated once, then reused, so that a decode step's call
    costs little host time."""
    cfg: ctypes.Array          # strides and sizes, as the launcher reads
    fcfg: ctypes.Array         # scale, softcap
    heads: int                 # B * Hkv
    n_acc: int                 # partial accumulators (floats)
    n_ml: int                  # partial (m, l) pairs (floats)
    device: int
    # per stream: the partials' scratch and the fused combine's arrival
    # counters (zero between calls: the last CTA of each head sets its
    # counter back to 0). Calls on one stream run in order, so they share
    # them; another stream gets its own.
    buffers: dict


_plans: dict[tuple, _Plan] = {}
_MAX_PLANS = 256


def tile_slots(d: int, elem_size: int) -> int:
    """Cache slots per shared-memory tile, as the kernel derives them:
    32 on the tensor cores (bf16, D = 64, 128, 256), else 8 KB."""
    if elem_size == 2 and d in (64, 128, 256):
        return 32
    return min(_MAX_TILE, _TILE_BYTES // (d * elem_size))


def splits_for(bh: int, sk: int, tile: int) -> int:
    """Splits a head may use at most (the grid's x): one per tile of the
    cache, and no more than about twice the CTAs the card holds at once
    over all heads. The kernel picks how many each head uses from
    ``kv_len``, on the device."""
    return max(1, min(-(-sk // tile), -(-2 * _TARGET_CTAS // max(bh, 1))))


def decode_attention_bhgd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: torch.Tensor, *,
                          window: int | None = None,
                          softcap: float | None = None,
                          scale: float | None = None) -> torch.Tensor:
    """q (B·Hkv, G, D), k/v (B·Hkv, Smax, D), kv_len (B·Hkv,) int32 as in
    the JAX kernel; or 4-D views q (B, Hkv, G, D), k/v (B, Hkv, Smax, D)
    of any strides with a unit dim stride, and kv_len (B, Hkv) of any
    strides (the model passes its (B, Smax, Hkv, D) caches as
    ``transpose(1, 2)`` views and ``kv_len[:, None].expand(B, Hkv)``).
    Slot s of head (b, h) is live when s < kv_len and, with a window,
    s > kv_len - 1 - window. Returns q's shape and dtype. CUDA tensors
    only."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"decode_attention kernel needs CUDA tensors, "
                         f"got {dev}")
    key = (q.shape, q.stride(), k.shape, k.stride(), v.shape, v.stride(),
           kv_len.shape, kv_len.stride(), q.dtype, k.dtype, v.dtype,
           kv_len.dtype, dev, k.get_device(), v.get_device(),
           kv_len.get_device(), window, softcap, scale)
    plan = _plans.get(key)
    if plan is None:
        if len(_plans) >= _MAX_PLANS:
            _plans.clear()
        plan = _plans[key] = _make_plan(q, k, v, kv_len, window, softcap,
                                        scale)
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    if (qp | kp | vp) % 16:
        raise ValueError("decode_attention: q, k and v need 16-byte "
                         "aligned storage (16-byte cp.async copies)")
    stream = _build.stream(dev)
    bufs = plan.buffers.get(stream)
    if bufs is None:
        bufs = plan.buffers[stream] = (
            torch.empty(plan.n_acc + plan.n_ml, dtype=torch.float32,
                        device=dev),
            torch.zeros(plan.heads, dtype=torch.int32, device=dev))
    sp = bufs[0].data_ptr()
    out = torch.empty_like(q)
    fn = _build.function("decode_attention", "repro_decode_attention", _ARGS)
    code = fn(qp, kp, vp, kv_len.data_ptr(), out.data_ptr(), sp,
              sp + 4 * plan.n_acc, bufs[1].data_ptr(),
              ctypes.addressof(plan.cfg), ctypes.addressof(plan.fcfg),
              plan.device, stream)
    _build.check("decode_attention", "decode_attention", code)
    decode_attention_bhgd.launches += 1
    return out


def _make_plan(q, k, v, kv_len, window, softcap, scale) -> _Plan:
    """Check one call signature against what the kernel takes (raises)
    and fix its launch configuration."""
    dev = q.device
    q4, k4, v4 = as_bhsd(q), as_bhsd(k), as_bhsd(v)
    kl = kv_len.unsqueeze(0) if kv_len.dim() == 1 else kv_len
    if q4.dim() != 4 or k4.dim() != 4 or k4.shape != v4.shape:
        raise ValueError("q, k, v must be 3-D (B·H, ., D) or 4-D "
                         "(B, H, ., D), k and v of one shape")
    b, hkv, g, d = q4.shape
    sk = k4.shape[2]
    if k4.shape[:2] != (b, hkv) or k4.shape[3] != d \
            or tuple(kl.shape) != (b, hkv):
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, kv_len {tuple(kv_len.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k, v must share one dtype, bfloat16 or float32")
    if kv_len.dtype != torch.int32:
        raise ValueError("kv_len must be int32")
    if any(t.device != dev for t in (k, v, kv_len)):
        raise ValueError("decode_attention inputs on several devices")
    esize = q.element_size()
    if d * esize not in ROW_BYTES or sk == 0:
        raise ValueError(f"needs head_dim x element size in {ROW_BYTES} "
                         f"bytes and Smax >= 1 (got D={d}, {q.dtype}, "
                         f"Smax={sk})")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    o4 = as_bhsd(torch.empty_like(q, device="meta"))
    # 16-byte cp.async copies and vector reads: no fallback where they fail
    check_strided("decode_attention", q4, k4, v4, o4, elems=16 // esize)
    splits = splits_for(b * hkv, sk, tile_slots(d, esize))
    cfg = (ctypes.c_longlong * 22)(
        *(s for t in (q4, k4, v4, o4) for s in t.stride()[:3]),
        *kl.stride(), b, hkv, g, sk, d, splits, _DTYPES[q.dtype],
        int(window or 0))
    fcfg = (ctypes.c_float * 2)(
        float(scale if scale is not None else d ** -0.5), float(softcap or 0))
    return _Plan(cfg, fcfg, b * hkv, b * hkv * splits * g * d,
                 b * hkv * splits * g * 2, dev.index or 0, {})


decode_attention_bhgd.launches = 0
