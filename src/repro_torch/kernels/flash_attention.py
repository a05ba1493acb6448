"""Flash-attention kernel wrapper: ``csrc/flash_attention.cu`` on CUDA
tensors.

Ports the Pallas TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention_bhsd``). The kernel, its design and its bound are
described in the source; the plain version is ``ref.flash_attention``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
         + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
# head_dim 80 runs the 128-wide tiling zero-padded in shared memory (see
# the source), as the Pallas kernel pads 64/80-dim heads to 128
HEAD_DIMS = (64, 80, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def as_bhsd(x: torch.Tensor) -> torch.Tensor:
    """A (B·H, S, D) tensor (the JAX kernel's layout) as the
    (1, B·H, S, D) view the kernel reads; 4-D tensors pass as they are."""
    return x.unsqueeze(0) if x.dim() == 3 else x


def check_strided(name: str, *ts: torch.Tensor, elems: int = 4) -> None:
    """The kernels read ``elems`` elements at a time (4: 16 or 8 bytes;
    the bf16 flash kernel's TMA maps need 16 bytes, 8 elements): unit dim
    stride, other strides multiples of ``elems``, 16-byte aligned
    storage."""
    for t in ts:
        if t.stride(-1) != 1 or any(s % elems for s in t.stride()[:-1]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors need a unit last stride, "
                             f"other strides multiples of {elems} and "
                             f"16-byte alignment (got strides {t.stride()})")


def launch_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                out: torch.Tensor, *, g: int, causal: bool = True,
                window: int | None = None, softcap: float | None = None,
                scale: float | None = None) -> tuple:
    """Check the shapes and options of one call and return the C
    entry's arguments before the stream: pointers, strides, (batch,
    Hq, g, Sq, Sk, head_dim, dtype, causal, window, scale, softcap,
    device). The head_dim passed, and the default scale
    ``head_dim ** -0.5``, are q's own (80 for an 80-dim head, whatever
    width the kernel tiles it with)."""
    q4, k4, v4 = as_bhsd(q), as_bhsd(k), as_bhsd(v)
    if q4.dim() != 4 or k4.shape != v4.shape or k4.dim() != 4:
        raise ValueError("q, k, v must be 3-D (B·H, S, D) or 4-D "
                         "(B, H, S, D), k and v of one shape")
    b, hq, sq, d = q4.shape
    _, hkv, sk, _ = k4.shape
    if k4.shape[0] != b or k4.shape[3] != d or hkv * g != hq:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, g={g}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k, v must share one dtype, bfloat16 or float32")
    if any(t.device != q.device for t in (k, v, out)):
        raise ValueError("flash_attention inputs on several devices")
    if sk == 0:
        raise ValueError("no keys (Sk == 0)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    o4 = as_bhsd(out)
    check_strided("flash_attention", q4, k4, v4, o4,
                  elems=16 // q.element_size())
    strides = (ctypes.c_longlong * 12)(*(s for t in (q4, k4, v4, o4)
                                         for s in t.stride()[:3]))
    return (q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), o4.data_ptr(),
            strides, b, hq, g, sq, sk, d, _DTYPES[q.dtype], int(causal),
            int(window or 0), float(scale if scale is not None else d ** -0.5),
            float(softcap or 0.0), q.device.index or 0)


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, g: int, causal: bool = True,
                         window: int | None = None,
                         softcap: float | None = None,
                         scale: float | None = None) -> torch.Tensor:
    """q (B·Hq, Sq, D), k/v (B·Hkv, Sk, D) as in the JAX kernel, or 4-D
    views q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) of any strides with a unit
    dim stride (the model passes ``x.transpose(1, 2)`` of its (B, S, H, D)
    tensors, read in place). Query head h reads key/value head h // g.
    Returns the output in q's shape and dtype, laid out like q where q is
    dense (so a transposed (B, S, H, D) input gives a contiguous
    (B, S, H, D) output back through ``transpose(1, 2)``). bf16 (the
    tensor-core kernel) or float32 (the FP32-core kernel); head_dim 64,
    80, 128 or 256. CUDA tensors only."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got {dev}")
    out = torch.empty_like(q)
    args = launch_args(q, k, v, out, g=g, causal=causal, window=window,
                       softcap=softcap, scale=scale)
    fn = _build.function("flash_attention", "repro_flash_attention", _ARGS)
    code = fn(*args[:4], ctypes.addressof(args[4]), *args[5:],
              _build.stream(dev))
    _build.check("flash_attention", "flash_attention", code)
    flash_attention_bhsd.launches += 1
    return out


flash_attention_bhsd.launches = 0
