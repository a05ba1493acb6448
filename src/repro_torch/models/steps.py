"""Serve steps, ported from ``repro/models/steps.py``: prefill, one
decode step, and a greedy decode loop. ``loss_fn`` and
``make_train_step`` wait for the training slice (ROADMAP.md, open
item 7)."""
from __future__ import annotations

import torch

from repro_torch.models import model as model_lib

ModelConfig = model_lib.ModelConfig


def make_prefill_step(cfg: ModelConfig):
    """prefill_step(params, batch) -> (last-position logits (B, 1, V),
    caches)."""

    def prefill_step(params, batch):
        h, caches = model_lib.prefill(cfg, params, batch)
        logits = model_lib.logits_from_hidden(cfg, params, h[:, -1:, :])
        return logits, caches

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """decode_step(params, caches, tokens (B, 1), kv_len (B,))
    -> (logits (B, 1, V), caches updated in place)."""

    def decode_step(params, caches, tokens, kv_len):
        h, caches = model_lib.decode_step_hidden(cfg, params, caches, tokens,
                                                 kv_len)
        return model_lib.logits_from_hidden(cfg, params, h), caches

    return decode_step


def greedy_decode(cfg: ModelConfig, params, caches, first_token, kv_len,
                  num_steps: int):
    """Autoregressive loop: -> (tokens (B, num_steps), caches, kv_len)."""
    decode_step = make_decode_step(cfg)
    tok, toks = first_token, []
    for _ in range(num_steps):
        logits, caches = decode_step(params, caches, tok, kv_len)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        kv_len = kv_len + 1
        toks.append(tok[:, 0])
    return torch.stack(toks, 1), caches, kv_len
