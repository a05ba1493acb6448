"""Analytic MODEL_FLOPS per step (the roofline's 'useful work' term),
ported from ``repro/models/flops.py``: host arithmetic over
``ModelConfig``.

MODEL_FLOPS = mult x N_active x tokens  +  attention term, where
mult = 6 for training (fwd 2 + bwd 4) and 2 for inference, N_active
excludes non-routed experts (MoE), and the attention term adds the
context-dependent score/value matmuls that parameter count misses:

  train/prefill (causal): 2 x mult x B x Hq x hd x S x S/2  per layer
  local layers:           ctx capped at the window
  decode:                 ctx = kv_len (one token)
"""
from __future__ import annotations

from repro_torch.models.model import ModelConfig


def attn_context(seq: int, causal: bool, window: int | None) -> float:
    ctx = seq / 2 if causal else seq
    if window:
        ctx = min(ctx, window)
    return ctx


def model_flops(cfg: ModelConfig, kind: str, batch: int, seq: int
                ) -> dict:
    """kind: train | prefill | decode. Returns component dict."""
    n_active = cfg.num_active_params()
    mult = 6 if kind == "train" else 2
    if kind == "decode":
        tokens = batch
        new_tokens = 1
    else:
        tokens = batch * seq
        new_tokens = seq
    param_flops = mult * n_active * tokens

    attn_flops = 0.0
    for i in range(cfg.num_layers):
        spec = cfg.layer_spec(i)
        if not spec.mixer.startswith("attn"):
            # SSD state update ~ L*H*(N*P)*k — folded into a small
            # constant times params; negligible next to projections
            continue
        window = cfg.window if spec.mixer == "attn_local" else None
        if kind == "decode":
            ctx = seq if not window else min(seq, window)
            q_rows = 1
        else:
            ctx = attn_context(seq, cfg.causal, window)
            q_rows = seq
        # QK^T and PV: 2 matmuls x 2 flops x B x Hq x hd x q_rows x ctx
        attn_flops += (mult / 2) * 4 * batch * cfg.num_heads \
            * cfg.head_dim * q_rows * ctx
    total = param_flops + attn_flops
    return {"param_flops": float(param_flops),
            "attn_flops": float(attn_flops),
            "total": float(total),
            "n_active": int(n_active),
            "tokens": int(tokens),
            "mult": mult,
            "new_tokens": int(new_tokens)}
