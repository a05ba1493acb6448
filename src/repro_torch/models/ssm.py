"""Mamba-2 (SSD, state-space duality) mixer, ported from
``repro/models/ssm.py``: the chunked path for training and prefill, and
the one-step recurrence for decode.

As in "Transformers are SSMs" (arXiv:2405.21060), the sequence is split
into chunks; within a chunk the quadratic (dual) form is used, across
chunks a recurrent state (B, H heads, N state, P head-dim) is carried.
The reference carries it with ``lax.scan``; here a Python loop over the
chunks does, so peak memory stays O(chunk^2) per chunk as there.

Float32 where the reference computes in it: ``dt`` through the
softplus, the conv's accumulation, the whole chunked scan, the ``D * x``
skip and the SSM state in the cache; the compute dtype elsewhere,
the conv tail in the cache included. The projections stay separate (z,
x, B, C, dt), as in the reference.

Split over the ``model`` ranks in sharded training
(``launch/fsdp.py``), a rank computes its heads: ``mamba2_share_bc``
(B and C, whole), ``mamba2_share_in`` (up to the gated norm's sum of
squares) and ``mamba2_share_out`` (the norm with the statistic summed
over the ranks, and the rank's rows of the out-projection).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (column_product, dense_init, rmsnorm,
                                       rmsnorm_init, row_product)

Params = dict[str, Any]


def ssm_dims(d_model: int, expand: int, head_dim: int) -> tuple[int, int]:
    d_inner = expand * d_model
    nheads = d_inner // head_dim
    return d_inner, nheads


def mamba2_init(gen, d_model: int, *, state: int, conv: int, expand: int,
                head_dim: int, dtype=torch.float32, device=None) -> Params:
    d_inner, nheads = ssm_dims(d_model, expand, head_dim)
    channels = d_inner + 2 * state
    p = {
        "wz": dense_init(gen, d_model, d_inner, dtype, device),
        "wx": dense_init(gen, d_model, d_inner, dtype, device),
        "wB": dense_init(gen, d_model, state, dtype, device),
        "wC": dense_init(gen, d_model, state, dtype, device),
        "wdt": dense_init(gen, d_model, nheads, dtype, device),
    }
    # depthwise causal conv over the x/B/C channels
    w = torch.randn((conv, channels), generator=gen, device=device,
                    dtype=torch.float32)
    p["conv_w"] = (w * 0.1).to(dtype)
    p["conv_b"] = torch.zeros((channels,), dtype=dtype, device=device)
    p["dt_bias"] = torch.zeros((nheads,), dtype=dtype, device=device)
    p["a_log"] = torch.log(torch.linspace(1.0, 16.0, nheads,
                                          device=device)).to(dtype)
    p["D"] = torch.ones((nheads,), dtype=dtype, device=device)
    p["norm"] = rmsnorm_init(d_inner, dtype, device)
    p["wo"] = dense_init(gen, d_inner, d_model, dtype, device)
    return p


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, L, C); w: (W, C). Returns (B, L, C)
    in x's dtype, accumulated in float32 in the reference's order."""
    width, length = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):          # width is tiny (4): shifted adds
        out = out + xp[:, i:i + length].float() * w[i].float()
    return (out + b.float()).to(x.dtype)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                bmat: torch.Tensor, cmat: torch.Tensor, *, chunk: int,
                init_state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x: (B, L, H, P) raw inputs (not yet scaled by dt); dt: (B, L, H)
    positive step sizes; a_log: (H,) with A = -exp(a_log); bmat/cmat:
    (B, L, N) (one group). Returns (y (B, L, H, P) in x's dtype, final
    state (B, H, N, P) float32)."""
    bsz, length, nheads, pdim = x.shape
    nstate = bmat.shape[-1]
    if length % chunk:
        raise ValueError(f"L={length} % chunk={chunk} != 0")
    a = -torch.exp(a_log.float())                     # (H,)
    log_a = dt.float() * a                            # (B, L, H), <= 0
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))[None, :, :, None]
    state = (init_state.float() if init_state is not None
             else torch.zeros((bsz, nheads, nstate, pdim),
                              dtype=torch.float32, device=x.device))
    ys = []
    for c0 in range(0, length, chunk):
        sl = slice(c0, c0 + chunk)
        xi, dti, lai = x[:, sl].float(), dt[:, sl].float(), log_a[:, sl]
        bi, ci = bmat[:, sl].float(), cmat[:, sl].float()
        cum = torch.cumsum(lai, dim=1)                # (B, Q, H) decreasing
        xdt = xi * dti[..., None]                     # (B, Q, H, P)
        # intra-chunk (dual / quadratic form). Mask BEFORE exp: the
        # upper triangle is exp(+large) -> inf, and a where() after it
        # would still pass NaN through the backward.
        seg = cum[:, :, None, :] - cum[:, None, :, :]  # (B, Qt, Qs, H)
        decay = torch.exp(torch.where(tri, seg, -torch.inf))
        scores = torch.einsum("btn,bsn->bts", ci, bi)
        # "bts,btsh,bshp->bthp" as (scores * decay) then one batched
        # product with xdt: never a (B, T, S, H, P) tensor
        m = (scores[..., None] * decay).permute(0, 3, 1, 2)  # (B, H, T, S)
        y = torch.matmul(m, xdt.permute(0, 2, 1, 3))          # (B, H, T, P)
        y = y.permute(0, 2, 1, 3)
        # inter-chunk, from the carried state
        y = y + torch.einsum("btn,bhnp->bthp", ci, state) \
            * torch.exp(cum)[..., None]
        # state update
        decay_to_end = torch.exp(cum[:, -1:, :] - cum)  # (B, Q, H) in (0, 1]
        new = torch.einsum("bsn,bshp->bhnp", bi,
                           xdt * decay_to_end[..., None])
        state = torch.exp(cum[:, -1])[:, :, None, None] * state + new
        ys.append(y)
    y = torch.cat(ys, dim=1)
    return y.to(x.dtype), state


def _in_proj(params: Params, x: torch.Tensor):
    z = x @ params["wz"]
    xs = x @ params["wx"]
    bm = x @ params["wB"]
    cm = x @ params["wC"]
    dt = F.softplus((x @ params["wdt"]).float() + params["dt_bias"].float())
    return z, torch.cat([xs, bm, cm], dim=-1), dt


def _out_proj(params: Params, y: torch.Tensor, z: torch.Tensor,
              norm_eps: float) -> torch.Tensor:
    y = rmsnorm(params["norm"], y * F.silu(z), eps=norm_eps)
    return y @ params["wo"]


def mamba2_forward(params: Params, x: torch.Tensor, *, state: int,
                   conv: int, expand: int, head_dim: int, chunk: int,
                   norm_eps: float = 1e-6, return_cache: bool = False):
    """Full-sequence mixer. x: (B, L, d_model) -> (B, L, d_model).

    With ``return_cache`` also returns the decode cache (the conv tail
    and the final SSM state): the prefill path."""
    bsz, length, d_model = x.shape
    d_inner, nheads = ssm_dims(d_model, expand, head_dim)
    z, xbc_raw, dt = _in_proj(params, x)
    xbc = F.silu(_causal_conv(xbc_raw, params["conv_w"], params["conv_b"]))
    xs, bm, cm = torch.split(xbc, [d_inner, state, state], dim=-1)
    xh = xs.reshape(bsz, length, nheads, head_dim)
    y, final_state = ssd_chunked(xh, dt, params["a_log"], bm, cm,
                                 chunk=chunk)
    y = y + params["D"].float()[None, None, :, None] * xh.float()
    y = y.reshape(bsz, length, d_inner).to(x.dtype)
    out = _out_proj(params, y, z, norm_eps)
    if return_cache:
        # a copy: a view would keep all of xbc_raw alive in the cache
        return out, {"conv": xbc_raw[:, -(conv - 1):, :].clone(),
                     "ssm": final_state}
    return out


def mamba2_share_bc(params: Params, xs: tuple, *, state: int
                    ) -> torch.Tensor:
    """B and C of a mixer split over the ``model`` ranks
    (``launch/fsdp.py``), which depend on no head: (B, L, 2N) in the
    compute dtype, after the conv and the silu, computed whole from the
    whole wB/wC (float32 leaves, cast to the compute dtype first: the one
    process's products) and the B/C channels of conv_w/conv_b. ``xs``:
    ``mamba2_share_in``'s. Every rank reads all of it on its heads, so
    it enters them through ``ModelSplit.run_staged``'s f of a shared
    tensor: their gradients are summed over the ranks in float32 and
    rounded once, as the one process rounds its own."""
    cd = params["wx"].dtype
    bm = column_product(xs[2], params["wB"], cd)
    cm = column_product(xs[3], params["wC"], cd)
    n = 2 * state
    return F.silu(_causal_conv(torch.cat([bm, cm], dim=-1),
                               params["conv_w"][:, -n:],
                               params["conv_b"][-n:]))


def mamba2_share_in(params: Params, xs: tuple, bc: torch.Tensor, *,
                    state: int, head_dim: int, chunk: int):
    """The first stage of one ``model`` rank's share of
    ``mamba2_forward`` split over the ranks (``launch/fsdp.py``):
    ``params`` holds its column blocks of wz/wx/wdt (H/m heads), its
    blocks of dt_bias/a_log/D, its channels of conv_w/conv_b/norm (its
    d_inner/m x-channels, then the 2N B/C channels) and the whole wB/wC
    as float32 partial leaves. ``xs``: the input in float32, one copy
    for each of the z, x, B, C and dt products (f's outputs,
    ``_in_proj``'s order); ``bc``: ``mamba2_share_bc``'s B and C, as
    float32. The z, x and dt products on the rank's columns, the conv on
    its x-channels (depthwise: each channel's values are the whole
    conv's), the scan, the D skip and the gate on its heads. Returns
    (the gated ``y * silu(z)`` on the rank's channels, cast to float32
    once, as ``rmsnorm`` casts it, so that the gradients of its two uses
    add in float32 before one rounding; its sum of squares over them,
    (B, L, 1)): the gated RMSNorm's statistic, which the ranks sum
    before any of them can normalise."""
    bsz, length, _ = xs[0].shape
    z = column_product(xs[0], params["wz"])
    xr = column_product(xs[1], params["wx"])
    dt = F.softplus(column_product(xs[4], params["wdt"]).float()
                    + params["dt_bias"].float())
    n = 2 * state
    xc = F.silu(_causal_conv(xr, params["conv_w"][:, :-n],
                             params["conv_b"][:-n]))
    xh = xc.reshape(bsz, length, -1, head_dim)
    y, _ = ssd_chunked(xh, dt, params["a_log"], bc[..., :state],
                       bc[..., state:], chunk=chunk)
    y = y + params["D"].float()[None, None, :, None] * xh.float()
    y = y.reshape(xr.shape).to(z.dtype)
    gated = (y * F.silu(z)).float()
    return gated, torch.sum(torch.square(gated), dim=-1, keepdim=True)


def mamba2_share_out(params: Params, gated: torch.Tensor,
                     sumsq: torch.Tensor, d_inner: int,
                     norm_eps: float = 1e-6) -> torch.Tensor:
    """The second stage: the gated RMSNorm of the rank's channels
    (``gated``, float32) with ``sumsq``, the sum of squares over all
    d_inner channels (summed over the ranks), as ``rmsnorm`` computes
    it, rounded to the compute dtype, then the row product
    (``row_product``) with the rank's rows of wo: (B, L, d_model)
    float32, not rounded, a partial sum over the ranks that g adds."""
    x = gated * torch.rsqrt(sumsq / d_inner + norm_eps)
    x = x * (1.0 + params["norm"]["scale"].float())
    return row_product(x.to(params["wo"].dtype), params["wo"])


def mamba2_init_cache(batch: int, d_model: int, *, state: int, conv: int,
                      expand: int, head_dim: int, dtype=torch.float32,
                      device=None) -> Params:
    d_inner, nheads = ssm_dims(d_model, expand, head_dim)
    return {
        "conv": torch.zeros((batch, conv - 1, d_inner + 2 * state),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, nheads, state, head_dim),
                           dtype=torch.float32, device=device),
    }


def mamba2_decode(params: Params, cache: Params, x: torch.Tensor, *,
                  state: int, conv: int, expand: int, head_dim: int,
                  norm_eps: float = 1e-6) -> tuple[torch.Tensor, Params]:
    """Single-token step. x: (B, 1, d_model). Returns (y, new cache); the
    cache given is not changed."""
    bsz, _, d_model = x.shape
    d_inner, nheads = ssm_dims(d_model, expand, head_dim)
    z, xbc, dt = _in_proj(params, x)
    dt = dt[:, 0]                                      # (B, H)
    conv_in = torch.cat([cache["conv"], xbc], dim=1)   # (B, W, C)
    conv_out = torch.sum(conv_in.float() * params["conv_w"].float()[None],
                         dim=1, keepdim=True) + params["conv_b"].float()
    xbc = F.silu(conv_out).to(x.dtype)
    xs, bm, cm = torch.split(xbc, [d_inner, state, state], dim=-1)
    xh = xs.reshape(bsz, nheads, head_dim).float()
    bm, cm = bm[:, 0].float(), cm[:, 0].float()        # (B, N)
    a = -torch.exp(params["a_log"].float())            # (H,)
    decay = torch.exp(dt * a)                          # (B, H)
    xdt = xh * dt[..., None]                           # (B, H, P)
    new_ssm = (decay[..., None, None] * cache["ssm"]
               + torch.einsum("bn,bhp->bhnp", bm, xdt))
    y = torch.einsum("bn,bhnp->bhp", cm, new_ssm)
    y = y + params["D"].float()[None, :, None] * xh
    y = y.reshape(bsz, 1, d_inner).to(x.dtype)
    return _out_proj(params, y, z, norm_eps), {"conv": conv_in[:, 1:],
                                                "ssm": new_ssm}
