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


def _attention_scores(q, k, *, g, causal, window, softcap, scale):
    """(raw scores, softcapped and masked scores, live mask) in float32,
    (B·Hq, Sq, Sk), as ``flash_attention`` computes them."""
    sq, d = q.shape[1], q.shape[2]
    sk = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    kq = torch.repeat_interleave(k, g, dim=0).float()
    raw = torch.einsum("hqd,hkd->hqk", q.float() * scale, kq)
    s = torch.tanh(raw / softcap) * softcap if softcap is not None else raw
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(sk, device=q.device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > (qp - window)
    return raw, torch.where(ok, s, torch.full_like(s, NEG_INF)), ok


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    g: int, causal: bool = True, window: int | None = None,
                    softcap: float | None = None,
                    scale: float | None = None, return_lse: bool = False):
    """Plain version of ``flash_attention.flash_attention_bhsd`` (JAX:
    ``kernels/ref.py:flash_attention``): dense attention in float32.
    q (B·Hq, Sq, D), k/v (B·Hkv, Sk, D); query head h reads key/value
    head h // g. Masked scores are NEG_INF, so a row with no live key
    averages V over all keys, as in the JAX kernel. With ``return_lse``
    returns ``(out, lse)``: lse (B·Hq, Sq) float32 is each row's
    logsumexp of the masked, scaled, softcapped scores (NEG_INF for a
    row with no live key), the backward's L."""
    _, s, _ = _attention_scores(q, k, g=g, causal=causal, window=window,
                                softcap=softcap, scale=scale)
    p = torch.softmax(s, dim=-1)
    vq = torch.repeat_interleave(v, g, dim=0).float()
    out = torch.einsum("hqk,hkd->hqd", p, vq).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor,
                        lse: torch.Tensor | None = None, *, g: int,
                        causal: bool = True, window: int | None = None,
                        softcap: float | None = None,
                        scale: float | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``flash_attention.flash_attention_bwd_bhsd``: dQ,
    dK, dV of ``flash_attention`` in float32, written out (no autograd)
    and cast to q's dtype. q/o/do (B·Hq, Sq, D), k/v (B·Hkv, Sk, D);
    L is each row's log-sum-exp of the masked scores S: ``lse`` (B·Hq,
    Sq), as the forward returns it, or recomputed here when none is
    given:

        P = exp(S - L), D = rowsum(dO o O), dV = P^T dO, dP = dO V^T,
        dS = P o (dP - D) o (1 - tanh^2 of the softcap),
        dQ = scale dS K, dK = scale dS^T Q,

    dK and dV summed over the g query heads of each kv head. A row with
    no live key has the forward's uniform P = 1/Sk (it adds dO/Sk to
    every dV row) and dS = 0: its output does not depend on its
    scores."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    raw, s, ok = _attention_scores(q, k, g=g, causal=causal, window=window,
                                   softcap=softcap, scale=scale)
    live = ok.any(dim=1)[:, None]                       # (Sq, 1)
    lse = (torch.logsumexp(s, dim=-1) if lse is None
           else lse.reshape(bh, sq).float())[..., None]
    p = torch.where(live, torch.exp(s - lse),
                    torch.full_like(s, 1.0 / sk))
    dof = do.float()
    vq, kq = (torch.repeat_interleave(x, g, dim=0).float() for x in (v, k))
    delta = (dof * o.float()).sum(-1, keepdim=True)
    dp = torch.einsum("hqd,hkd->hqk", dof, vq)
    ds = torch.where(ok, p * (dp - delta), torch.zeros_like(p))
    if softcap is not None:
        ds = ds * (1.0 - torch.tanh(raw / softcap) ** 2)
    dq = torch.einsum("hqk,hkd->hqd", ds, kq) * scale
    dk = torch.einsum("hqk,hqd->hkd", ds, q.float()) * scale
    dv = torch.einsum("hqk,hqd->hkd", p, dof)
    dk = dk.reshape(bh // g, g, sk, d).sum(1)
    dv = dv.reshape(bh // g, g, sk, d).sum(1)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


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


def decode_attention_partial(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, kv_len: torch.Tensor, *,
                             window: int | None = None,
                             softcap: float | None = None,
                             scale: float | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``decode_attention.decode_attention_partial_bhgd``
    (the decode kernel's partial mode) over one slice of a cache whose
    sequence is split: q (B·Hkv, G, D), k/v (B·Hkv, Sk, D), kv_len
    (B·Hkv,) the lengths shifted by the slice's first slot (any value:
    <= 0 or above Sk too). Slot s is live when s < kv_len and, with a
    window, s > kv_len - 1 - window. Returns (o, lse) in float32: each
    row's softmax-weighted sum of V over the live slots and the
    log-sum-exp of their scores; o = 0 and lse = -inf where no slot is
    live (the row weighs nothing in ``models.attention.combine_partials``,
    where the whole-cache version gives the mean of V)."""
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
    s = torch.where(ok, s, torch.full_like(s, float("-inf")))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.where(ok, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    return torch.einsum("hgk,hkd->hgd", p, v.float()), lse


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
