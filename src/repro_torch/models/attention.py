"""Attention: dense, chunked (online-softmax) and decode paths, ported
from ``repro/models/attention.py``.

All paths share one math definition and are tested against each other
and against the JAX package. The ``impl`` switch picks the path of a
full-sequence attention: ``"dense"`` and ``"chunked"`` are plain
PyTorch (the card's plain route), ``"kernel"`` is the hand-written flash
kernel (``kernels.ops.flash_attention``, with its hand-written backward
where grad is on; ``"pallas"``, the JAX configs' name for it, means the
same), and ``"auto"`` resolves on the tensors'
device: the kernel on CUDA, dense or chunked by length on the CPU, as
the JAX package picks dense/chunked off the TPU. The decode step takes
the same switch (``decode``): the kernel, or the dense
``decode_attention`` below.
"""
from __future__ import annotations

import torch

NEG_INF = -2.0e38
KERNEL_IMPLS = ("kernel", "pallas")


def resolve_impl(impl: str, x: torch.Tensor, sk: int) -> str:
    """``"auto"`` -> ``"kernel"`` on a CUDA tensor, else ``"chunked"``
    past 2048 keys and ``"dense"`` below; ``"pallas"`` -> ``"kernel"``."""
    if impl == "auto":
        if x.is_cuda:
            return "kernel"
        return "chunked" if sk > 2048 else "dense"
    if impl in KERNEL_IMPLS:
        return "kernel"
    if impl in ("dense", "chunked"):
        return impl
    raise ValueError(impl)


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: int | None) -> torch.Tensor:
    """(Sq, Sk) additive bias: 0 where attending is allowed, NEG_INF
    otherwise."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > (q_pos[:, None] - window)
    return torch.where(ok, 0.0, NEG_INF).float()


def dense_attention(q, k, v, *, causal=True, window=None, logit_softcap=None,
                    q_offset=0, k_offset=0, kv_len=None, scale=None):
    """Reference attention. q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D).
    ``kv_len``: optional (B,) active key length (entries >= kv_len
    masked)."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qr = q.reshape(b, sq, hkv, g, d).float() * scale
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qr, k.float())
    if logit_softcap is not None:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = k_offset + torch.arange(sk, device=q.device)
    scores = scores + _mask_bias(q_pos, k_pos, causal, window)
    if kv_len is not None:
        live = k_pos[None, :] < kv_len[:, None]            # (B, Sk)
        scores = torch.where(live[:, None, None, None, :], scores,
                             torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


def chunked_attention(q, k, v, *, causal=True, window=None,
                      logit_softcap=None, chunk_size=512, scale=None):
    """Online-softmax attention over key chunks (no Sq x Sk buffer)."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    if sk % chunk_size:
        raise ValueError(f"sk={sk} not divisible by chunk={chunk_size}")
    qr = q.reshape(b, sq, hkv, g, d).float() * scale
    q_pos = torch.arange(sq, device=q.device)
    acc = torch.zeros((b, hkv, g, sq, d), dtype=torch.float32,
                      device=q.device)
    row_max = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32,
                         device=q.device)
    denom = torch.zeros((b, hkv, g, sq), dtype=torch.float32,
                        device=q.device)
    for c0 in range(0, sk, chunk_size):
        ki = k[:, c0:c0 + chunk_size].float()
        vi = v[:, c0:c0 + chunk_size].float()
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qr, ki)
        if logit_softcap is not None:
            scores = torch.tanh(scores / logit_softcap) * logit_softcap
        k_pos = c0 + torch.arange(chunk_size, device=q.device)
        scores = scores + _mask_bias(q_pos, k_pos, causal, window)
        new_max = torch.maximum(row_max, scores.amax(dim=-1))
        corr = torch.exp(row_max - new_max)
        p = torch.exp(scores - new_max[..., None])
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vi)
        denom = denom * corr + p.sum(dim=-1)
        row_max = new_max
    out = acc / torch.clamp(denom[..., None], min=1e-30)
    out = out.permute(0, 3, 1, 2, 4)                      # (b, sq, hkv, g, d)
    return out.reshape(b, sq, hq, d).to(q.dtype)


def decode_attention(q, k_cache, v_cache, *, kv_len, window=None,
                     logit_softcap=None, scale=None):
    """Single-step decode, dense. q: (B, 1, Hq, D); caches
    (B, Smax, Hkv, D); kv_len (B,) lengths including the new token."""
    b = q.shape[0]
    q_off = kv_len - 1
    sk = k_cache.shape[1]
    _, _, hq, d = q.shape
    hkv = k_cache.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qr = q.reshape(b, 1, hkv, g, d).float() * scale
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qr, k_cache.float())
    if logit_softcap is not None:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    k_pos = torch.arange(sk, device=q.device)
    ok = k_pos[None, :] < kv_len[:, None]      # causal: only written slots
    if window is not None:
        ok &= k_pos[None, :] > (q_off[:, None] - window)
    scores = torch.where(ok[:, None, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v_cache.float())
    return out.reshape(b, 1, hq, d).to(q.dtype)


def attention(q, k, v, *, causal=True, window=None, logit_softcap=None,
              impl: str = "auto", chunk_size: int = 512, scale=None):
    """Dispatch (module docstring): the kernel on CUDA, dense for short
    sequences and chunked for long ones on the CPU."""
    sk = k.shape[1]
    impl = resolve_impl(impl, q, sk)
    if impl == "dense":
        return dense_attention(q, k, v, causal=causal, window=window,
                               logit_softcap=logit_softcap, scale=scale)
    if impl == "chunked":
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 logit_softcap=logit_softcap,
                                 chunk_size=min(chunk_size, sk), scale=scale)
    from repro_torch.kernels import ops as kops
    return kops.flash_attention(q, k, v, causal=causal, window=window,
                                logit_softcap=logit_softcap, scale=scale)


def decode(q, k_cache, v_cache, *, kv_len, window=None, logit_softcap=None,
           impl: str = "auto", scale=None):
    """One-token attention over the caches: the decode kernel where
    ``impl`` resolves to ``"kernel"``, else ``decode_attention``."""
    if resolve_impl(impl, q, k_cache.shape[1]) != "kernel":
        return decode_attention(q, k_cache, v_cache, kv_len=kv_len,
                                window=window, logit_softcap=logit_softcap,
                                scale=scale)
    from repro_torch.kernels import ops as kops
    return kops.decode_attention(q, k_cache, v_cache, kv_len, window=window,
                                 logit_softcap=logit_softcap, scale=scale)
