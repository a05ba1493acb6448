"""Decode-attention kernel wrapper: ``csrc/decode_attention.cu`` on
CUDA tensors.

Ports the Pallas TPU kernel ``src/repro/kernels/decode_attention.py``
(``decode_attention_bhgd``). The kernel, its design and its bound are
described in the source; the plain version is ``ref.decode_attention``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import _DTYPES, as_bhsd, check_strided

_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
         + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
_TILE = 64              # cache slots per tile (kTK in the source)
_TARGET_CTAS = 528      # about four CTAs on each of the H100's 132 SMs
MAX_ROWS_X_DIM = 4096   # G * D the kernel's registers hold


def splits_for(bh: int, sk: int) -> int:
    """Key splits per head: enough CTAs to fill the card, at most one
    per 64-slot tile of the cache."""
    return max(1, min(-(-sk // _TILE), -(-_TARGET_CTAS // max(bh, 1))))


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
    if d % 4 or g * d > MAX_ROWS_X_DIM or sk == 0:
        raise ValueError(f"needs head_dim % 4 == 0, G·D <= {MAX_ROWS_X_DIM} "
                         f"and Smax >= 1 (got G={g}, D={d}, Smax={sk})")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    out = torch.empty_like(q)
    o4 = as_bhsd(out)
    check_strided("decode_attention", q4, k4, v4, o4)
    splits = splits_for(b * hkv, sk)
    part_acc = torch.empty(b * hkv * splits * g * d, dtype=torch.float32,
                           device=dev)
    part_ml = torch.empty(b * hkv * splits * g * 2, dtype=torch.float32,
                          device=dev)
    strides = (ctypes.c_longlong * 14)(
        *(s for t in (q4, k4, v4, o4) for s in t.stride()[:3]),
        *kl.stride())
    fn = _build.function("decode_attention", "repro_decode_attention", _ARGS)
    code = fn(q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), kl.data_ptr(),
              o4.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
              ctypes.addressof(strides), b, hkv, g, sk, d, splits,
              _DTYPES[q.dtype], int(window or 0),
              float(scale if scale is not None else d ** -0.5),
              float(softcap or 0.0), dev.index or 0,
              torch.cuda.current_stream(dev).cuda_stream)
    _build.check("decode_attention", "decode_attention", code)
    decode_attention_bhgd.launches += 1
    return out


decode_attention_bhgd.launches = 0
