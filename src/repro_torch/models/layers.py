"""Core neural-net layers, ported from ``repro/models/layers.py``.

Parameters are nested dicts of tensors; every layer is
``apply(params, x, ...)``. Initializers take an explicit
``torch.Generator`` (``None`` on the meta device, where nothing is
drawn) and device. They draw other numbers than ``jax.random`` from the
same seed; tests carry the JAX package's weights across instead
(``models/convert.py``).

``apply_mrope`` and the cross-entropy losses are not here yet: they
belong to the VLM slice and the training slice (ROADMAP.md, item 7).
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def _normal(shape, gen, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32)


def dense_init(gen, d_in: int, d_out: int, dtype=torch.float32,
               device="cpu") -> torch.Tensor:
    scale = 1.0 / math.sqrt(d_in)
    return (_normal((d_in, d_out), gen, device) * scale).to(dtype)


def embed_init(gen, vocab: int, d: int, dtype=torch.float32,
               device="cpu") -> torch.Tensor:
    return (_normal((vocab, d), gen, device) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype=torch.float32, device="cpu") -> Params:
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

def rope_freqs(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
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


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def mlp_init(gen, d_model: int, d_ff: int, dtype=torch.float32,
             device="cpu") -> Params:
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


# ---------------------------------------------------------------------------
# Softcap
# ---------------------------------------------------------------------------

def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap
