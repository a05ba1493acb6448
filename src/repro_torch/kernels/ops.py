"""Executor-facing kernel entry points.

Each entry point launches its CUDA kernel when its tensors lie on a
CUDA device and runs the kernel's plain PyTorch version (``ref``) when
they lie on the CPU — the only reason it takes the plain version. A
kernel that fails to build or launch raises; nothing falls back. On the
meta device (the dry run, ``launch/dryrun.py``) the kernel's wrapper
checks the call and allocates its outputs and scratch as on the card,
and launches nothing: the plain versions would allocate what the
kernels never do (the flash forward's (B, H, S, S) scores).

The JAX package's ``ops`` chose among Pallas, the Pallas interpreter
and jnp twins by backend, with a dense/scatter size split
(``SEG_DENSE_NSEG_MAX``) measured on the CPU. Here the aggregate
kernel takes any segment count, so there is no size split. The
attention entry points keep the JAX public layouts ((B, S, H, D)
tensors, (B, Smax, Hkv, D) caches); on the card the kernels read them
in place through strides, where the JAX wrappers made ``moveaxis``
copies (``src/repro/kernels/ops.py:72-74, 90-92``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import hash_join as _hj
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import seg_aggregate as _seg
from repro_torch.kernels import seg_topk as _stk


def flash_attention(q, k, v, *, causal=True, window=None,
                    logit_softcap=None, scale=None):
    """q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D) -> (B, Sq, Hq, D), through
    ``FlashAttention``: the forward kernel (and, where an input requires
    grad, the backward kernel) on CUDA, their plain versions on the CPU.
    With grad off or no input requiring it, the call runs the forward
    alone, stores no log-sum-exp for a backward and builds no graph."""
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    out = _fa.FlashAttention.apply(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        q.shape[2] // k.shape[2], causal, window, logit_softcap, scale, grad)
    return out.transpose(1, 2)


def decode_attention(q, k_cache, v_cache, kv_len, *, window=None,
                     logit_softcap=None, scale=None):
    """q (B, 1, Hq, D), caches (B, Smax, Hkv, D), kv_len (B,) int32 ->
    (B, 1, Hq, D)."""
    b, _, hq, d = q.shape
    _, sk, hkv, _ = k_cache.shape
    g = hq // hkv
    kw = dict(window=window, softcap=logit_softcap, scale=scale)
    if q.device.type != "cpu":
        out = _dec.decode_attention_bhgd(
            q.reshape(b, hkv, g, d), k_cache.transpose(1, 2),
            v_cache.transpose(1, 2), kv_len[:, None].expand(b, hkv), **kw)
    else:
        out = _ref.decode_attention(
            q.reshape(b * hkv, g, d),
            k_cache.transpose(1, 2).reshape(b * hkv, sk, d),
            v_cache.transpose(1, 2).reshape(b * hkv, sk, d),
            torch.repeat_interleave(kv_len, hkv), **kw)
    return out.reshape(b, 1, hq, d)


def decode_attention_partial(q, k_cache, v_cache, kv_len, *, window=None,
                             logit_softcap=None, scale=None):
    """The decode kernel's partial mode over one rank's slice of the
    caches: q (B, 1, Hq, D), caches (B, S, Hkv, D) (the slice), kv_len
    (B,) int32 shifted by the slice's first slot -> (o (B, 1, Hq, D)
    float32, lse (B, 1, Hq) float32), the rows' partials that
    ``models.attention.combine_partials`` combines over the ranks."""
    b, _, hq, d = q.shape
    _, sk, hkv, _ = k_cache.shape
    g = hq // hkv
    kw = dict(window=window, softcap=logit_softcap, scale=scale)
    if q.device.type != "cpu":
        o, lse = _dec.decode_attention_partial_bhgd(
            q.reshape(b, hkv, g, d), k_cache.transpose(1, 2),
            v_cache.transpose(1, 2), kv_len[:, None].expand(b, hkv), **kw)
    else:
        o, lse = _ref.decode_attention_partial(
            q.reshape(b * hkv, g, d),
            k_cache.transpose(1, 2).reshape(b * hkv, sk, d),
            v_cache.transpose(1, 2).reshape(b * hkv, sk, d),
            torch.repeat_interleave(kv_len, hkv), **kw)
    return o.reshape(b, 1, hq, d), lse.reshape(b, 1, hq)


def hash_join_probe(build_keys, build_valid, probe_keys, probe_valid):
    """Same results as ``executor.hash_join_probe``: (pos, matched,
    bucket overflow [P]). The kernel probes a hash table that holds every
    valid build row and verifies each hit on the keys themselves, so the
    result is exact (the smallest matching build index); there is no
    bucket to overflow and the flag is always False."""
    if build_valid.device.type != "cpu":
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
    fn = _ref.segmented_aggregate if values.device.type == "cpu" \
        else _seg.segmented_aggregate
    return fn(values, ok, segments, valid, num_segments)


def segmented_sum_count(values, segments, valid, num_segments: int):
    """Per-segment sum and count of one column: values/segments/valid
    [P, N] -> (sums [P, S], counts [P, S]) float32."""
    fn = _ref.segmented_sum_count if values.device.type == "cpu" \
        else _seg.segmented_sum_count
    return fn(values, segments, valid, num_segments)


def segment_topk(keys, cap: int):
    """Stable top-k selection (the ORDER BY / LIMIT entry point):
    keys[0] the invalid-sink flag, then the sort keys most significant
    first (descending ones negated), each [P, N] -> idx [P, cap]."""
    fn = _ref.segment_topk if keys[0].device.type == "cpu" \
        else _stk.segment_topk
    return fn(tuple(keys), cap)
