"""Gradient compression with error feedback (cross-pod DP traffic),
ported from ``repro/runtime/compression.py``.

At multi-pod scale the pod-axis gradient all-reduce crosses the slow
links between pods. Int8 symmetric quantization with per-tensor scales
cuts that traffic 4x (vs f32 master grads); the quantization error is
fed back into the next step's gradient (error feedback), which keeps
SGD-style convergence guarantees.

Where the JAX version runs inside ``shard_map``/``vmap`` over a named
axis (``lax.pmax`` / ``lax.psum``), this one runs on every rank of a
``torch.distributed`` group (gloo on the CPU, NCCL across cards):

    ef = ErrorFeedback.init(grads)
    grads, ef = compressed_mean(grads, ef, group=pod_group)
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.models.model import _leaves, tree_map

Params = Any


@dataclasses.dataclass
class ErrorFeedback:
    residual: Params

    @classmethod
    def init(cls, like: Params) -> "ErrorFeedback":
        return cls(residual=tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), like))


def compressed_mean(grads: Params, ef: ErrorFeedback, group=None
                    ) -> tuple[Params, ErrorFeedback]:
    """Int8+EF mean over the ranks of ``group`` (``None``: the default
    group). Every rank calls it with its own gradients."""
    n = dist.get_world_size(group)

    def one(g, r):
        g = g.to(torch.float32) + r
        # shared scale: a tiny max first so every rank quantizes into the
        # same grid (per-rank scales would not survive a sum)
        amax = torch.clamp(torch.max(torch.abs(g)), min=1e-12)
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = amax / 127.0
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        approx = q.to(torch.float32) * scale
        new_r = g - approx                       # error feedback
        # int8 payload summed in int32 (overflow-safe for <= 2^24 ranks)
        total = q.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        mean = total.to(torch.float32) * scale / n
        return mean, new_r

    out = [one(g, r) for g, r in zip(_leaves(grads), _leaves(ef.residual))]
    means = iter([o[0] for o in out])
    resid = iter([o[1] for o in out])
    return (tree_map(lambda _: next(means), grads),
            ErrorFeedback(residual=tree_map(lambda _: next(resid), grads)))
