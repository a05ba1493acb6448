"""Train / prefill / decode step functions, ported from
``repro/models/steps.py``.

``make_train_step`` builds the train step: microbatch gradient
accumulation, the mean, the schedule and the AdamW update. Where the
JAX step takes ``jax.value_and_grad`` of ``loss_fn``, the port runs
``loss.backward()`` into the ``.grad`` of detached views of the
parameters (no copy of the weights): microbatches accumulate into the
same float32 buffers, in the JAX order (0 + g1 + g2 + ...), with no
second tree of gradients alive. On the card the attention's gradient
comes from the flash-attention backward kernel
(``kernels.flash_attention.FlashAttention``).

On a mesh (``make_train_step(..., layout=)``, a ``launch/fsdp.Layout``)
the parameters and the AdamW state are this rank's blocks; each rank takes
its rows of every global microbatch, gathers each layer where it runs,
and its gradients reach its blocks summed over the ranks that split the
batch. The loss of a microbatch is the nll summed over every rank's
rows over the valid labels counted over every rank's rows (the
reference's ``tot / max(cnt, 1)`` over the whole microbatch), and the
gradient norm is summed over the ranks that hold distinct blocks.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import model as model_lib
from repro_torch.models.layers import (chunked_cross_entropy_loss,
                                       chunked_cross_entropy_sums)
from repro_torch.optim import adamw_update, warmup_cosine

ModelConfig = model_lib.ModelConfig


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def loss_fn(cfg: ModelConfig, params: Any, batch: dict,
            aux_weight: float = 0.01, layout=None
            ) -> tuple[torch.Tensor, dict]:
    """(loss, {"ce", "moe_aux"}). With ``layout`` (``launch/fsdp``),
    ``params`` are this rank's blocks and ``batch`` its rows, and the
    loss is this rank's share: its nll sum over the count of valid
    labels on every rank that splits the batch. Where the layout splits
    the vocabulary, the output table is this rank's V/m rows and the nll
    is combined over ``model`` (``layers.chunked_cross_entropy_sums``)."""
    h, moe_aux = model_lib.forward(cfg, params, batch, layout)
    b, s, d = h.shape
    labels = batch["labels"]
    if labels.shape[1] != s:  # vlm: patches prefix carries no labels
        pad = s - labels.shape[1]
        labels = torch.cat([torch.full((b, pad), -1, dtype=labels.dtype,
                                       device=labels.device), labels], 1)
    kw = dict(num_chunks=cfg.ce_chunks,
              final_softcap=cfg.final_logit_softcap or None)
    if layout is None:
        emb = model_lib.output_embedding(cfg, params).to(cfg.cdtype)
        ce = chunked_cross_entropy_loss(h.reshape(b * s, d), emb,
                                        labels.reshape(b * s), **kw)
    else:
        head = "embed" if cfg.tie_embeddings else "lm_head"
        emb = model_lib.output_embedding(
            cfg, layout.gather_top(params, (head,), cfg.cdtype))
        tot, cnt = chunked_cross_entropy_sums(h.reshape(b * s, d), emb,
                                              labels.reshape(b * s),
                                              vocab=layout.vocab, **kw)
        ce = tot / torch.clamp(layout.batch_sum(cnt), min=1.0)
    loss = ce + aux_weight * moe_aux
    return loss, {"ce": ce, "moe_aux": moe_aux}


def _trainable(params: Any) -> Any:
    """Views of the parameters that are leaves of a new autograd graph
    (the same storage; their ``.grad`` collects the gradients)."""
    return model_lib.tree_map(lambda t: t.detach().requires_grad_(), params)


def _grads(tp: Any) -> Any:
    return model_lib.tree_map(
        lambda t: t.grad.float() if t.grad is not None
        else torch.zeros(t.shape, dtype=torch.float32, device=t.device), tp)


def _backward(cfg: ModelConfig, tp: Any, batch: dict,
              aux_weight: float = 0.01, layout=None
              ) -> tuple[torch.Tensor, dict]:
    """loss_fn on ``tp`` (from ``_trainable``) and its backward, which
    adds the gradients into ``tp``'s ``.grad``: (loss, parts),
    detached; with ``layout``, summed over the ranks that split the
    batch (the whole batch's)."""
    loss, parts = loss_fn(cfg, tp, batch, aux_weight, layout)
    loss.backward()
    if layout is None:
        return loss.detach(), {k: v.detach() for k, v in parts.items()}
    return layout.batch_sum(loss), {k: layout.batch_sum(v)
                                    for k, v in parts.items()}


def value_and_grad(cfg: ModelConfig, params: Any, batch: dict,
                   aux_weight: float = 0.01, layout=None
                   ) -> tuple[torch.Tensor, dict, Any]:
    """``jax.value_and_grad(loss_fn, has_aux=True)``: (loss, parts,
    grads), the gradients a float32 tree shaped like ``params``. With
    ``layout`` (``launch/fsdp.Layout``): ``params`` are this rank's
    blocks, ``batch`` the global batch (this rank takes its rows), the
    loss the whole batch's and the gradients this rank's blocks of the
    whole batch's."""
    if layout is not None:
        batch = layout.local_batch(batch)
    tp = _trainable(params)
    loss, parts = _backward(cfg, tp, batch, aux_weight, layout)
    return loss, parts, _grads(tp)


def split_microbatches(batch: dict, n: int) -> list[dict]:
    """``n`` microbatches of ``batch``, in order: every leaf splits on its
    leading axis, except the M-RoPE ``positions`` (3, B, S), whose batch
    lives on axis 1."""
    out = [{} for _ in range(n)]
    for key, x in batch.items():
        ax = 1 if key == "positions" else 0
        if x.shape[ax] % n:
            raise ValueError(f"{key}: batch {x.shape[ax]} not divisible "
                             f"into {n} microbatches")
        for i, part in enumerate(torch.chunk(x, n, dim=ax)):
            out[i][key] = part
    return out


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, *, num_microbatches: int = 1,
                    peak_lr: float = 3e-4, warmup_steps: int = 100,
                    total_steps: int = 10_000, weight_decay: float = 0.1,
                    layout=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics); the parameters and the optimizer state are updated in
    place (``optim.adamw``).

    ``batch`` leaves have leading dim global_batch; it is split into
    ``num_microbatches`` accumulation steps to bound activation memory.
    ``metrics``: ``loss``, ``lr``, ``grad_norm``, and with one
    microbatch ``ce`` and ``moe_aux`` (0-d tensors on the device).

    ``layout``: a ``launch/fsdp.Layout`` of the parameters on a
    ``("data", "model")`` mesh (module docstring): ``params`` and
    ``opt_state`` are this rank's blocks, ``batch`` the global batch;
    the metrics are the whole batch's."""

    def local(micro):
        return micro if layout is None else layout.local_batch(micro)

    def train_step(params, opt_state, batch):
        tp = _trainable(params)
        if num_microbatches == 1:
            loss, parts = _backward(cfg, tp, local(batch), layout=layout)
            grads = _grads(tp)
        else:
            loss = None
            for micro in split_microbatches(batch, num_microbatches):
                lm, _ = _backward(cfg, tp, local(micro), layout=layout)
                loss = lm if loss is None else loss + lm
            inv = 1.0 / num_microbatches
            grads = _grads(tp)
            with torch.no_grad():
                for g in model_lib._leaves(grads):
                    g.mul_(inv)
            loss = loss * inv
            parts = {}
        del tp
        lr = warmup_cosine(opt_state["step"], peak_lr=peak_lr,
                           warmup_steps=warmup_steps,
                           total_steps=total_steps)
        params, opt_state, om = adamw_update(
            grads, opt_state, params, lr=lr, weight_decay=weight_decay,
            decay_mask=model_lib.decay_mask(params),
            norm_groups=None if layout is None
            else layout.norm_groups(grads))
        metrics = {"loss": loss, "lr": lr, **om, **parts}
        return params, opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------

def _head(cfg: ModelConfig, params, layout):
    """The weights ``logits_from_hidden`` reads: ``params``, or on a
    serve's mesh this rank's (its V/m rows of the output table where
    the vocabulary splits)."""
    if layout is None:
        return params
    return layout.top(params, ("lm_head",) if "lm_head" in params
                      else ("embed",))


def make_prefill_step(cfg: ModelConfig, layout=None):
    """prefill_step(params, batch) -> (last-position logits (B, 1, V),
    caches). ``layout`` (``launch/fsdp.ServeLayout``): ``params`` are
    this rank's blocks and ``batch`` its rows (``model.prefill_split``);
    the logits are this rank's V/m columns where the vocabulary splits,
    and the caches hold the heads the rank computed
    (``ServeLayout.fill_caches`` relays them)."""

    def prefill_step(params, batch):
        if layout is None:
            h, caches = model_lib.prefill(cfg, params, batch)
        else:
            h, caches = model_lib.prefill_split(cfg, params, batch, layout)
        logits = model_lib.logits_from_hidden(cfg, _head(cfg, params, layout),
                                              h[:, -1:, :])
        return logits, caches

    return prefill_step


def make_decode_step(cfg: ModelConfig, layout=None):
    """decode_step(params, caches, tokens (B, 1), kv_len (B,))
    -> (logits (B, 1, V), caches updated in place). ``layout``: as
    ``make_prefill_step``'s, ``caches`` this rank's blocks
    (``model.decode_step_split``)."""

    def decode_step(params, caches, tokens, kv_len):
        if layout is None:
            h, caches = model_lib.decode_step_hidden(cfg, params, caches,
                                                     tokens, kv_len)
        else:
            h, caches = model_lib.decode_step_split(cfg, params, caches,
                                                    tokens, kv_len, layout)
        return model_lib.logits_from_hidden(
            cfg, _head(cfg, params, layout), h), caches

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
