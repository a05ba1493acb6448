"""AdamW with global-norm clipping and int8 gradient compression helpers,
ported from ``repro/optim/adamw.py``.

The state mirrors the parameter tree: ``{"step": int32 0-d tensor,
"m": tree, "v": tree}`` with m and v in float32. Where the JAX update is
pure, this one updates the parameters, m and v in place (under
``torch.no_grad``): at qwen3-1.7b's width each of the three trees is
6.9 GB of float32, and a second copy of any of them would not fit
beside the step's activations.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.models.model import _leaves, tree_map

Params = Any


def adamw_init(params: Params) -> dict:
    leaf = next(iter(_leaves(params)))
    return {
        "step": torch.zeros((), dtype=torch.int32, device=leaf.device),
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
    }


def global_norm(tree: Params, norm_groups: list | None = None
                ) -> torch.Tensor:
    """The square root of the sum of every leaf's squares. Over a
    sharded tree (each rank holds blocks, ``launch/fsdp.py``),
    ``norm_groups`` gives each leaf (``_leaves`` order) the process
    groups whose ranks hold its distinct blocks: leaves that share
    groups are summed locally, all-reduced over those groups, then
    added, so a leaf replicated over an axis counts once and every rank
    gets the same norm. With no group anywhere (one rank) the sum is
    the unsharded one, in the same order."""
    if norm_groups is None:
        norm_groups = [()] * len(list(_leaves(tree)))
    buckets: dict = {}
    for leaf, groups in zip(_leaves(tree), norm_groups):
        sq = torch.sum(torch.square(leaf.float()))
        buckets[groups] = sq if groups not in buckets \
            else buckets[groups] + sq
    total = None
    for groups, sq in buckets.items():
        for group in groups:
            dist.all_reduce(sq, group=group)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads: Params, max_norm: float,
                        norm_groups: list | None = None
                        ) -> tuple[Params, torch.Tensor]:
    """Scale the gradients in place so that their global norm
    (``global_norm``) is at most ``max_norm``; returns them and the norm
    before clipping."""
    norm = global_norm(grads, norm_groups)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    with torch.no_grad():
        for g in _leaves(grads):
            g.mul_(scale)
    return grads, norm


def compress_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization (for cross-pod gradient
    exchange; used with error feedback in runtime.compression)."""
    amax = torch.clamp(torch.max(torch.abs(g)), min=1e-12)
    scale = amax / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


@torch.no_grad()
def adamw_update(grads: Params, opt_state: dict, params: Params, *,
                 lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, max_grad_norm: float = 1.0,
                 decay_mask: Params | None = None,
                 norm_groups: list | None = None
                 ) -> tuple[Params, dict, dict]:
    """One AdamW step with global-norm clipping. Updates ``params`` and
    the state's m and v in place (the gradients too: cast to float32 and
    clipped) and returns (params, new state, {"grad_norm"}). Weight decay
    applies to leaves with ndim >= 2 only (not norms or biases), or
    where ``decay_mask`` (a tree of bools like ``params``) says so; the
    bias corrections are ``1 - b ** step`` in float32. On a sharded
    tree, ``norm_groups`` (``global_norm``) makes the clip the same on
    every rank; the update is elementwise and runs on the blocks."""
    grads = tree_map(lambda g: g.float(), grads)
    grads, grad_norm = clip_by_global_norm(grads, max_grad_norm,
                                           norm_groups)
    step = opt_state["step"] + 1
    stepf = step.to(torch.float32)
    bc1 = 1.0 - b1 ** stepf
    bc2 = 1.0 - b2 ** stepf
    lr = torch.as_tensor(lr, dtype=torch.float32, device=stepf.device)
    decay = (_leaves(decay_mask) if decay_mask is not None
             else (p.dim() >= 2 for p in _leaves(params)))
    for p, g, m, v, wd in zip(_leaves(params), _leaves(grads),
                              _leaves(opt_state["m"]),
                              _leaves(opt_state["v"]), decay):
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        delta = (m / bc1).div_(torch.sqrt(v / bc2).add_(eps))
        pf = p if p.dtype == torch.float32 else p.float()
        if wd:
            delta.add_(pf, alpha=weight_decay)
        if pf is p:
            p.sub_(delta.mul_(lr))
        else:
            p.copy_(pf - delta.mul_(lr))
    new_state = {"step": step, "m": opt_state["m"], "v": opt_state["v"]}
    return params, new_state, {"grad_norm": grad_norm}
