"""Carry parameters between the JAX package's tree and the port's.

The JAX tree (``repro/models/model.py:init_params``) holds ``"embed"``,
``"blocks"`` (a tuple over the period pattern of dicts whose leaves are
stacked on a leading K = num_layers / period axis), ``"final_norm"`` and,
untied, ``"lm_head"``. The port holds one dict per layer in
``"layers"``; layer i is period position i % P of repeat i // P. Given
numpy arrays, ``params_from_numpy`` builds the port's tree and
``params_to_numpy`` the JAX one; the round trip is exact. The AdamW
state ``{"step", "m", "v"}`` (m and v in the parameter layout) goes
across the same way (``opt_state_from_numpy`` / ``opt_state_to_numpy``).
No JAX import: the caller converts JAX arrays with ``np.asarray``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.executor import resolve_device
from repro_torch.models.model import ModelConfig, Params, tree_map


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(cfg: ModelConfig, tree: Params, device=None
                      ) -> Params:
    """JAX-layout tree of numpy arrays -> the port's parameters on
    ``device`` (``None``: the GPU)."""
    device = resolve_device(device)
    p, k = cfg.period, cfg.repeats
    if len(tree["blocks"]) != p:
        raise ValueError(f"{len(tree['blocks'])} block groups for a period "
                         f"of {p}")
    layers = [tree_map(lambda a, r=i // p: _tensor(a[r], device),
                       tree["blocks"][i % p]) for i in range(k * p)]
    out = {key: tree_map(lambda a: _tensor(a, device), val)
           for key, val in tree.items() if key != "blocks"}
    out["layers"] = layers
    return out


def stack_layers(cfg: ModelConfig, per_layer: list) -> tuple:
    """Per-layer trees (parameters or caches) -> the JAX layout: a tuple
    over the period pattern of trees stacked on a leading K axis."""
    p = cfg.period

    def stack(*leaves):
        return torch.stack(leaves)

    groups = []
    for pidx in range(p):
        group = per_layer[pidx::p]
        groups.append(_zip_map(stack, group))
    return tuple(groups)


def _zip_map(fn, trees: list):
    first = trees[0]
    if isinstance(first, dict):
        return {key: _zip_map(fn, [t[key] for t in trees]) for key in first}
    return fn(*trees)


def params_to_numpy(cfg: ModelConfig, params: Params) -> Params:
    """The port's parameters -> the JAX-layout tree of numpy arrays."""
    out = {key: tree_map(lambda t: t.detach().cpu().numpy(), val)
           for key, val in params.items() if key != "layers"}
    out["blocks"] = tree_map(lambda t: t.detach().cpu().numpy(),
                             stack_layers(cfg, params["layers"]))
    return out


def opt_state_from_numpy(cfg: ModelConfig, state: dict, device=None
                         ) -> dict:
    """JAX AdamW state (``repro/optim/adamw.py``: ``step`` int32, ``m``
    and ``v`` in the JAX parameter layout) of numpy arrays -> the
    port's on ``device`` (``None``: the GPU)."""
    device = resolve_device(device)
    return {"step": _tensor(np.asarray(state["step"], np.int32), device),
            "m": params_from_numpy(cfg, state["m"], device),
            "v": params_from_numpy(cfg, state["v"], device)}


def opt_state_to_numpy(cfg: ModelConfig, state: dict) -> dict:
    """The port's AdamW state -> the JAX layout of numpy arrays."""
    return {"step": state["step"].detach().cpu().numpy(),
            "m": params_to_numpy(cfg, state["m"]),
            "v": params_to_numpy(cfg, state["v"])}
