"""Plain PyTorch versions of the kernels: what each kernel computes,
written with tensor operations only. The CPU path runs them, the tests
hold them against the JAX package's Pallas kernels, and on the card
they are the kernels' parity target. Every function takes a leading
partition dimension [P, ...], like its kernel, except the two attention
functions, which keep the JAX reference's layouts ((B·H, S, D) and
(B·Hkv, G, D)).

None of the segment and join versions is a transcription of the TPU kernel's blocked one-hot or
dense-compare form: at the main path's shapes on the card those cost
O(N x S) and O(NP x NB). Each is instead an exact formulation of the
same function (sort + binary search, scatter-reduce, chained stable
sorts)."""
from __future__ import annotations

import torch

I32_MAX = 2**31 - 1
I64_MAX = 2**63 - 1
NEG_INF = -2.0e38      # the masked score of the JAX kernels (not -inf)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    g: int, causal: bool = True, window: int | None = None,
                    softcap: float | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Plain version of ``flash_attention.flash_attention_bhsd`` (JAX:
    ``kernels/ref.py:flash_attention``): dense attention in float32.
    q (B·Hq, Sq, D), k/v (B·Hkv, Sk, D); query head h reads key/value
    head h // g. Masked scores are NEG_INF, so a row with no live key
    averages V over all keys, as in the JAX kernel."""
    sq, d = q.shape[1], q.shape[2]
    sk = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    kq = torch.repeat_interleave(k, g, dim=0).float()
    vq = torch.repeat_interleave(v, g, dim=0).float()
    s = torch.einsum("hqd,hkd->hqk", q.float() * scale, kq)
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(sk, device=q.device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > (qp - window)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,hkd->hqd", p, vq).to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, *, window: int | None = None,
                     softcap: float | None = None,
                     scale: float | None = None) -> torch.Tensor:
    """Plain version of ``decode_attention.decode_attention_bhgd`` (JAX:
    ``kernels/ref.py:decode_attention``): q (B·Hkv, G, D), k/v
    (B·Hkv, Sk, D), kv_len (B·Hkv,). Slot s is live when s < kv_len and,
    with a window, s > kv_len - 1 - window."""
    d = q.shape[2]
    sk = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    s = torch.einsum("hgd,hkd->hgk", q.float() * scale, k.float())
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    kp = torch.arange(sk, device=q.device)[None, None, :]
    kl = kv_len.to(torch.int64)[:, None, None]
    ok = kp < kl
    if window is not None:
        ok &= kp > (kl - 1 - window)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hgk,hkd->hgd", p, v.float()).to(q.dtype)


def _composite(keys: tuple[torch.Tensor, ...]) -> torch.Tensor:
    """1-2 int32 key columns -> one int64 key, order-free but exact."""
    k = keys[0].to(torch.int64)
    if len(keys) == 2:
        k = (k << 32) | (keys[1].to(torch.int64) & 0xFFFFFFFF)
    return k


def block_join_probe(build_keys: tuple[torch.Tensor, ...],
                     build_valid: torch.Tensor,
                     probe_keys: tuple[torch.Tensor, ...],
                     probe_valid: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``hash_join.block_join_probe`` (JAX:
    ``kernels/hash_join.py:block_join_probe``): for each probe row the
    smallest build index with equal keys where both rows are valid,
    else -1. build [P, NB], probe [P, NP] -> (pos [P, NP] int32,
    matched [P, NP] bool).

    Sort the build side by (valid first, key), stably, so that among
    equal keys the smallest index comes first; a left binary search
    then finds it. Exact for any keys, duplicates included."""
    if len(build_keys) != len(probe_keys) or not 1 <= len(build_keys) <= 2:
        raise ValueError("1 or 2 key columns on each side")
    nb = build_keys[0].shape[1]
    if nb == 0:
        pos = torch.full(probe_keys[0].shape, -1, dtype=torch.int32,
                         device=probe_valid.device)
        return pos, pos >= 0
    bk = _composite(build_keys)
    _, by_key = torch.sort(bk, dim=1, stable=True)
    inval = (~build_valid).to(torch.int8).gather(1, by_key)
    _, by_valid = torch.sort(inval, dim=1, stable=True)
    order = by_key.gather(1, by_valid)               # valid rows first
    skeys = bk.gather(1, order)
    svalid = build_valid.gather(1, order)
    # the valid prefix is ascending; the invalid tail reads int64 max
    sorted_keys = torch.where(svalid, skeys, torch.full_like(skeys, I64_MAX))
    pk = _composite(probe_keys)
    lo = torch.searchsorted(sorted_keys.contiguous(), pk.contiguous())
    at = lo.clamp(max=nb - 1)
    matched = (probe_valid & (lo < nb) & svalid.gather(1, at)
               & (skeys.gather(1, at) == pk))
    pos = torch.where(matched, order.gather(1, at),
                      torch.full_like(lo, -1)).to(torch.int32)
    return pos, matched


def _flat_segments(segments: torch.Tensor, valid: torch.Tensor,
                   num_segments: int) -> tuple[torch.Tensor, torch.Tensor]:
    """[P, N] segment ids -> flat slot ids into [P * S + 1] (the last
    slot collects dropped rows) and the kept-row mask."""
    p = segments.shape[0]
    keep = valid & (segments >= 0) & (segments < num_segments)
    base = (torch.arange(p, device=segments.device)
            * num_segments)[:, None]
    slot = torch.where(keep, base + segments.to(torch.int64),
                       torch.full_like(base, p * num_segments))
    return slot.reshape(-1), keep


def segmented_aggregate(values: torch.Tensor, ok: torch.Tensor,
                        segments: torch.Tensor, valid: torch.Tensor,
                        num_segments: int):
    """Plain version of ``seg_aggregate.segmented_aggregate`` (JAX:
    ``kernels/seg_aggregate.py:segmented_aggregate``). values/ok
    [P, N, C], segments/valid [P, N] -> counts [P, S], sums/mins/maxs
    [P, S, C], all float32. ``valid`` drops whole rows, ``ok`` single
    values; segment ids outside [0, S) are dropped; empty slots read
    0 / +inf / -inf. C may be 0 (counts only)."""
    p, n, nc = values.shape
    s = num_segments
    slot, keep = _flat_segments(segments, valid, s)
    dev = values.device
    counts = torch.zeros(p * s + 1, dtype=torch.float32, device=dev)
    counts.index_add_(0, slot, keep.reshape(-1).to(torch.float32))
    okm = (ok & keep[:, :, None]).reshape(p * n, nc)
    v = values.to(torch.float32).reshape(p * n, nc)
    sums = torch.zeros(p * s + 1, nc, dtype=torch.float32, device=dev)
    sums.index_add_(0, slot, torch.where(okm, v, torch.zeros_like(v)))
    idx = slot[:, None].expand(p * n, nc)
    inf = torch.full_like(v, float("inf"))
    mins = torch.full((p * s + 1, nc), float("inf"), device=dev)
    mins.scatter_reduce_(0, idx, torch.where(okm, v, inf), "amin")
    maxs = torch.full((p * s + 1, nc), float("-inf"), device=dev)
    maxs.scatter_reduce_(0, idx, torch.where(okm, v, -inf), "amax")
    return (counts[:-1].reshape(p, s), sums[:-1].reshape(p, s, nc),
            mins[:-1].reshape(p, s, nc), maxs[:-1].reshape(p, s, nc))


def segmented_sum_count(values: torch.Tensor, segments: torch.Tensor,
                        valid: torch.Tensor, num_segments: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``seg_aggregate.segmented_sum_count`` (JAX:
    ``kernels/ref.py:segmented_sum_count``; the legacy group-by route
    calls it). values/segments/valid [P, N] -> (sums [P, S],
    counts [P, S]) float32."""
    p = values.shape[0]
    s = num_segments
    slot, keep = _flat_segments(segments, valid, s)
    v = torch.where(keep, values.to(torch.float32),
                    torch.zeros((), device=values.device))
    sums = torch.zeros(p * s + 1, dtype=torch.float32, device=values.device)
    sums.index_add_(0, slot, v.reshape(-1))
    cnts = torch.zeros(p * s + 1, dtype=torch.float32, device=values.device)
    cnts.index_add_(0, slot, keep.reshape(-1).to(torch.float32))
    return sums[:-1].reshape(p, s), cnts[:-1].reshape(p, s)


def segment_topk(keys: tuple[torch.Tensor, ...], cap: int) -> torch.Tensor:
    """Plain version of ``seg_topk.segment_topk`` (JAX:
    ``kernels/seg_topk.py:segment_topk``): the first ``cap`` indices of
    the stable ascending lexicographic order, keys[0] most significant
    (the invalid-sink flag), ties broken on the row index. keys: tuple
    of [P, N] -> [P, cap] int32.

    torch has no lexsort: stable sorts chained from the least
    significant key to the most significant one give the same order."""
    p, n = keys[0].shape
    order = torch.arange(n, device=keys[0].device).expand(p, n)
    for k in reversed(keys):
        if k.is_floating_point():
            k = k + 0.0        # -0.0 -> +0.0: a radix sort tells them apart
        _, perm = torch.sort(k.gather(1, order), dim=1, stable=True)
        order = order.gather(1, perm)
    return order[:, :cap].to(torch.int32)
