"""Core neural-net layers, ported from ``repro/models/layers.py``.

Parameters are nested dicts of tensors; every layer is
``apply(params, x, ...)``. Initializers take an explicit
``torch.Generator`` (``None`` on the meta device, where nothing is
drawn) and device. They draw other numbers than ``jax.random`` from the
same seed; tests carry the JAX package's weights across instead
(``models/convert.py``).
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def _normal(shape, gen, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32)


def _scaled_normal(shape, scale: float, gen, dtype: torch.dtype,
                   device) -> torch.Tensor:
    if gen is None:            # the meta device: shapes only, nothing drawn
        return torch.empty(shape, dtype=dtype, device=device)
    return (_normal(shape, gen, device) * scale).to(dtype)


def dense_init(gen, d_in: int, d_out: int, dtype: torch.dtype,
               device) -> torch.Tensor:
    return _scaled_normal((d_in, d_out), 1.0 / math.sqrt(d_in), gen, dtype,
                          device)


def embed_init(gen, vocab: int, d: int, dtype: torch.dtype,
               device) -> torch.Tensor:
    return _scaled_normal((vocab, d), 0.02, gen, dtype, device)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype: torch.dtype, device) -> Params:
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """RMSNorm with (1 + scale) parameterization, computed in float32."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + params["scale"].float())).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions broadcastable to
    (..., seq)."""
    half = x.shape[-1] // 2
    inv = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * inv        # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]              # (..., seq, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple[int, ...]) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL). x: (..., seq, heads, head_dim);
    positions: (3, ..., seq) for (t, h, w).

    ``sections`` splits the head_dim // 2 rotary channels among the
    three position components, in order; sum(sections) == head_dim // 2.
    The reference computes all three components' angles in float32 and
    picks one per channel with a one-hot sum; computing each channel's
    angle from its own component only gives the same float32 values.
    The split is by Python ints: nothing is copied to the device or read
    back (a tensor of ``sections`` would cost a sync a call, two a layer
    in every decode step)."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to {half}")
    inv = rope_freqs(x.shape[-1], theta, x.device)
    parts, lo = [], 0
    for comp, n in enumerate(sections):
        parts.append(positions[comp][..., None].float() * inv[lo:lo + n])
        lo += n
    angles = torch.cat(parts, dim=-1)                 # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def mlp_init(gen, d_model: int, d_ff: int, dtype: torch.dtype,
             device) -> Params:
    return {
        "wi_gate": dense_init(gen, d_model, d_ff, dtype, device),
        "wi_up": dense_init(gen, d_model, d_ff, dtype, device),
        "wo": dense_init(gen, d_ff, d_model, dtype, device),
    }


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def mlp(params: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    h = _act(x @ params["wi_gate"], act) * (x @ params["wi_up"])
    return h @ params["wo"]


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of 2-D operands of one dtype as float32, not rounded to
    that dtype: on the card a float32-output GEMM (the tensor cores'
    float32 accumulators written out), elsewhere the operands upcast."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _ColumnProduct(torch.autograd.Function):
    """``x @ w`` in ``w``'s dtype, as the one-process layer computes it
    (``x32``: a float32 copy of compute-dtype values, cast back first),
    whose input gradient is float32 and not rounded (``_mm_f32``): over
    a block of ``w``'s columns, a partial sum that f adds over the
    ranks. The weight's gradient is the one-process product's."""

    @staticmethod
    def forward(ctx, x32, w):
        x = x32.to(w.dtype)
        ctx.save_for_backward(x, w)
        return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dx = _mm_f32(g2, w.T)
        return dx.view(*g.shape[:-1], -1), x.reshape(-1, x.shape[-1]).T @ g2


class _RowProduct(torch.autograd.Function):
    """``a @ w`` in float32, not rounded (``_mm_f32``): over a block of
    ``w``'s rows, a partial sum that g adds over the ranks. Its
    gradients are the one-process product's, in ``a``'s dtype."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return _mm_f32(a.reshape(-1, a.shape[-1]), w).view(
            *a.shape[:-1], -1)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g2 = g.to(a.dtype).reshape(-1, g.shape[-1])
        da = (g2 @ w.T).view(*a.shape)
        return da, a.reshape(-1, a.shape[-1]).T @ g2


#: the column- and row-parallel products of a split sublayer
column_product, row_product = _ColumnProduct.apply, _RowProduct.apply


def mlp_share(params: Params, xs: tuple, act: str = "silu") -> torch.Tensor:
    """One ``model`` rank's share of a dense MLP split over the ranks
    (``launch/fsdp.py``): ``params`` holds its column blocks of
    wi_gate/wi_up and the matching row block of wo. ``xs``: the input in
    float32, one copy for each column product. ``mlp``'s products on
    the rank's columns, the last one's output float32 and not rounded:
    a partial sum over the ranks."""
    h = _act(column_product(xs[0], params["wi_gate"]), act) \
        * column_product(xs[1], params["wi_up"])
    return row_product(h, params["wo"])


# ---------------------------------------------------------------------------
# Softcap
# ---------------------------------------------------------------------------

def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------------
# Cross entropy
# ---------------------------------------------------------------------------

def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross-entropy. logits (..., V), computed in float32;
    labels (...)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def _chunk_nll(xi: torch.Tensor, embed: torch.Tensor, li: torch.Tensor,
               final_softcap: float | None):
    """(sum of the chunk's nll over valid labels, count of valid labels):
    the chunk's logits in the compute dtype, then float32, then the
    softcap, then the logsumexp, as the JAX scan body orders them."""
    logits = (xi @ embed.T).float()
    if final_softcap is not None:
        logits = softcap(logits, final_softcap)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, li.clamp(min=0).long()[..., None])[..., 0]
    valid = (li >= 0).float()
    return torch.sum((logz - gold) * valid), torch.sum(valid)


def chunked_cross_entropy_loss(x: torch.Tensor, embed: torch.Tensor,
                               labels: torch.Tensor, num_chunks: int = 8,
                               final_softcap: float | None = None
                               ) -> torch.Tensor:
    """The mean nll over the valid labels: ``chunked_cross_entropy_sums``'
    sum over max(count, 1)."""
    tot, cnt = chunked_cross_entropy_sums(x, embed, labels, num_chunks,
                                          final_softcap)
    return tot / torch.clamp(cnt, min=1.0)


def chunked_cross_entropy_sums(x: torch.Tensor, embed: torch.Tensor,
                               labels: torch.Tensor, num_chunks: int = 8,
                               final_softcap: float | None = None
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy without materializing the full (T, V) logits: (the
    sum of nll over the valid labels, their count), float32.

    x: (T, d) final hidden states, embed: (V, d) output embedding matrix,
    labels: (T,), -1 ignored. T is padded to a multiple of
    ``num_chunks`` (with label -1); each chunk computes its own logits
    and reduces them to a sum of nll. Where grad is on, each chunk runs
    under activation checkpointing, so its logits are recomputed in the
    backward instead of kept: at qwen3-1.7b's width a chunk of 1024 rows
    holds 1024 x 151936 logits in bf16 and float32."""
    t = x.shape[0]
    pad = (-t) % num_chunks
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    xc = x.reshape(num_chunks, -1, x.shape[-1])
    lc = labels.reshape(num_chunks, -1)
    remat = torch.is_grad_enabled() and (x.requires_grad
                                         or embed.requires_grad)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for xi, li in zip(xc, lc):
        if remat:
            nll, valid = checkpoint(_chunk_nll, xi, embed, li, final_softcap,
                                    use_reentrant=False)
        else:
            nll, valid = _chunk_nll(xi, embed, li, final_softcap)
        tot = tot + nll
        cnt = cnt + valid
    return tot, cnt
