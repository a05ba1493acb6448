"""Flash-attention kernel wrappers: ``csrc/flash_attention.cu`` (the
forward) and ``csrc/flash_attention_bwd.cu`` (its backward) on CUDA
tensors, and ``FlashAttention``, the autograd function that joins them.

The forward ports the Pallas TPU kernel
``src/repro/kernels/flash_attention.py`` (``flash_attention_bhsd``); the
backward has no Pallas counterpart (the JAX package lets XLA
differentiate its dense/chunked attention). The kernels, their designs
and their bounds are described in the sources; the plain versions are
``ref.flash_attention`` and ``ref.flash_attention_bwd``.

On meta tensors (the dry run, ``launch/dryrun.py``) each wrapper checks
its arguments and allocates its outputs as on the card, and launches
nothing (its count stays).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
         + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
_BWD_ARGS = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
             + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
# head_dim 80 runs the 128-wide tiling zero-padded in shared memory (see
# the source), as the Pallas kernel pads 64/80-dim heads to 128
HEAD_DIMS = (64, 80, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the backward's query tile: its scratch holds Sq rounded up to this
_BWD_ROWS = 128


def bwd_kernels(dtype: torch.dtype, head_dim: int) -> tuple[str, str]:
    """The two kernels of ``csrc/flash_attention_bwd.cu`` that a backward
    of this dtype and head_dim launches: bf16 at head_dim 64, 80 and 128
    on the tensor cores, float32 (every head_dim) and bf16 at 256 on the
    FP32 cores. Mirrors the C entry's dispatch."""
    if dtype == torch.bfloat16 and head_dim != 256:
        return ("bwd_dq_tc", "bwd_dkdv_tc")
    return ("bwd_dq", "bwd_dkdv")


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
                         scale: float | None = None,
                         return_lse: bool = False):
    """q (B·Hq, Sq, D), k/v (B·Hkv, Sk, D) as in the JAX kernel, or 4-D
    views q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) of any strides with a unit
    dim stride (the model passes ``x.transpose(1, 2)`` of its (B, S, H, D)
    tensors, read in place). Query head h reads key/value head h // g.
    Returns the output in q's shape and dtype, laid out like q where q is
    dense (so a transposed (B, S, H, D) input gives a contiguous
    (B, S, H, D) output back through ``transpose(1, 2)``). bf16 (the
    tensor-core kernel) or float32 (the FP32-core kernel); head_dim 64,
    80, 128 or 256. CUDA tensors only. With ``return_lse`` the kernel also
    stores each row's log-sum-exp of the scaled, softcapped, masked scores
    (float32, q's shape without the head dim), the backward's L, and the
    call returns ``(out, lse)``; without it nothing more is stored (the
    serve path) and the output's bits are the same."""
    dev = q.device
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got {dev}")
    out = torch.empty_like(q)
    args = launch_args(q, k, v, out, g=g, causal=causal, window=window,
                       softcap=softcap, scale=scale)
    lse = (torch.empty(q.shape[:-1], dtype=torch.float32, device=dev)
           if return_lse else None)
    if dev.type == "meta":
        return (out, lse) if return_lse else out
    fn = _build.function("flash_attention", "repro_flash_attention", _ARGS)
    code = fn(*args[:4], lse.data_ptr() if return_lse else None,
              ctypes.addressof(args[4]), *args[5:], _build.stream(dev))
    _build.check("flash_attention", "flash_attention", code)
    flash_attention_bhsd.launches += 1
    by = flash_attention_bhsd.by_window
    by[window or None] = by.get(window or None, 0) + 1
    return (out, lse) if return_lse else out


flash_attention_bhsd.launches = 0
# the launches by ``window`` (None: no window), counted with ``launches``
flash_attention_bhsd.by_window = {}


def flash_attention_bwd_bhsd(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor, *, g: int,
                             causal: bool = True,
                             window: int | None = None,
                             softcap: float | None = None,
                             scale: float | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """dQ, dK, dV of ``flash_attention_bhsd(q, k, v)`` given its output
    ``o``, the output's gradient ``do`` (q's shape; any strides with a
    unit dim stride) and the row log-sum-exps ``lse`` that the forward
    returned (``return_lse=True``: float32, contiguous, q's shape without
    the head dim). Same layouts, dtypes and head dims as the forward; the
    gradients come back in q's dtype, each laid out like its input where
    that is dense. One call launches the two kernels of
    ``csrc/flash_attention_bwd.cu`` that ``bwd_kernels`` names (counted
    once). CUDA tensors only."""
    dev = q.device
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention_bwd kernel needs CUDA tensors, "
                         f"got {dev}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    args = launch_args(q, k, v, dq, g=g, causal=causal, window=window,
                       softcap=softcap, scale=scale)
    o4, do4 = as_bhsd(o), as_bhsd(do)
    dk4, dv4 = as_bhsd(dk), as_bhsd(dv)
    if o4.shape != as_bhsd(q).shape or do4.shape != o4.shape \
            or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError("o and do must have q's shape and dtype")
    if lse.shape != q.shape[:-1] or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"lse must be the forward's contiguous float32 "
                         f"{tuple(q.shape[:-1])}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    if any(t.device != dev for t in (o, do, lse)):
        raise ValueError("flash_attention_bwd inputs on several devices")
    check_strided("flash_attention_bwd", o4, do4, dk4, dv4,
                  elems=16 // q.element_size())
    b, hq, sq, _ = as_bhsd(q).shape
    if sq == 0:
        return dq, dk.zero_(), dv.zero_()
    rows = -(-sq // _BWD_ROWS) * _BWD_ROWS
    scratch = torch.empty(b * hq * rows * 2, dtype=torch.float32, device=dev)
    if dev.type == "meta":
        return dq, dk, dv
    # strides of q, k, v (the forward's first 9), o, do, dq, dk, dv
    strides = (ctypes.c_longlong * 24)(
        *args[4][:9], *(s for t in (o4, do4, as_bhsd(dq), dk4, dv4)
                        for s in t.stride()[:3]))
    fn = _build.function("flash_attention_bwd", "repro_flash_attention_bwd",
                         _BWD_ARGS)
    code = fn(args[0], args[1], args[2], o4.data_ptr(), do4.data_ptr(),
              lse.data_ptr(), args[3], dk4.data_ptr(), dv4.data_ptr(),
              scratch.data_ptr(), ctypes.addressof(strides), *args[5:],
              _build.stream(dev))
    _build.check("flash_attention_bwd", "flash_attention_bwd", code)
    flash_attention_bwd_bhsd.launches += 1
    return dq, dk, dv


flash_attention_bwd_bhsd.launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention on (B, H, S, D) views: the forward
    kernel and the backward kernel on CUDA tensors, the plain versions
    (``ref.flash_attention`` / ``ref.flash_attention_bwd``) on the CPU;
    meta tensors go to the wrappers too, which allocate the outputs and
    launch nothing. The forward also asks for each row's log-sum-exp L
    and saves it beside q, k, v and the output; the backward takes L as
    it is. A caller that knows no gradient will be asked for passes
    ``want_lse=False`` (``ops.flash_attention`` with grad off: the serve
    path), and then no L is stored. Both kernels give the same bits
    every launch, so a recomputed forward under activation checkpointing
    matches the first one."""

    @staticmethod
    def forward(ctx, q, k, v, g, causal, window, softcap, scale,
                want_lse=True):
        kw = dict(g=g, causal=causal, window=window, softcap=softcap,
                  scale=scale)
        if q.device.type == "cpu":
            res = _plain(q, k, v, return_lse=want_lse, **kw)
        else:
            res = flash_attention_bhsd(q, k, v, return_lse=want_lse, **kw)
        o, lse = res if want_lse else (res, None)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()         # autograd may hand back a strided grad
        if q.device.type == "cpu":
            grads = _plain_bwd(q, k, v, o, do, lse, **ctx.kw)
        else:
            grads = flash_attention_bwd_bhsd(q, k, v, o, do, lse, **ctx.kw)
        return (*grads, None, None, None, None, None, None)


def _flat(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.reshape(b * h, s, d)


def _plain(q, k, v, *, return_lse: bool = False, **kw):
    """The plain forward on (B, H, S, D) views (and its L, (B, H, S))."""
    res = ref.flash_attention(_flat(q), _flat(k), _flat(v),
                              return_lse=return_lse, **kw)
    if return_lse:
        return res[0].reshape(q.shape), res[1].reshape(q.shape[:-1])
    return res.reshape(q.shape)


def _plain_bwd(q, k, v, o, do, lse, **kw) -> tuple:
    """The plain backward on (B, H, S, D) views, given the forward's L."""
    dq, dk, dv = ref.flash_attention_bwd(
        _flat(q), _flat(k), _flat(v), _flat(o), _flat(do),
        lse.reshape(-1, lse.shape[-1]), **kw)
    return dq.reshape(q.shape), dk.reshape(k.shape), dv.reshape(v.shape)
