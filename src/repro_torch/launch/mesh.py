"""Meshes and sharding rules, ported from ``repro/launch/mesh.py``.

Two kinds of mesh:

* ``make_data_mesh``: the 1-D ``("data",)`` mesh of spmd query
  execution, one partition of the database a rank
  (``Executor.compile(mode="spmd", mesh=...)``);
* the LM mesh: ``("data", "model")``, with an outer ``"pod"`` axis for
  several pods. ``make_host_mesh`` and ``make_mesh`` build it as a
  ``torch.distributed`` ``DeviceMesh`` over the initialized group;
  ``make_production_mesh`` gives the reference's pod meshes (16 x 16,
  2 x 16 x 16) as a ``MeshShape``: axis names and sizes, no devices,
  which is all the spec functions need (the counterpart of
  ``compat.make_abstract_mesh``).

Sharding rules are name-based over the parameter tree, rule for rule
the reference's:
  embed (V,d)               -> (model, data)
  attention wq/wk/wv (d,H)  -> (data, model);  wo (H,d) -> (model, data)
  mlp wi/gate (d,ff)        -> (data, model);  wo (ff,d) -> (model, data)
  moe experts (E,d,ff)      -> E over model (expert parallelism),
                               d/ff over data
  mamba in-proj (d,din)     -> (data, model);  out (din,d) -> (model, data)
  norms / small vectors     -> replicated
Dims that do not divide the axis size stay unsharded. Batch dims shard
over (pod, data). Decode KV caches shard sequence over ``model`` and
batch over (pod, data); when batch is too small (long_500k: batch=1)
the sequence takes both axes.

A spec is a plain tuple with one entry per tensor dim: ``None``, an
axis name, or a tuple of names (the entries of a JAX
``PartitionSpec``; a dim over ``("pod", "data")`` is split pod-major).
Spec trees mirror the tree they describe with dicts and lists; in a
spec tree a tuple is always a leaf. The JAX tree stacks each layer leaf
on a leading K axis (``"blocks"``); the port keeps one dict per layer
(``params["layers"][i]``, ``models/convert.py``), so a port layer
leaf's spec is the reference's without its first entry. Which block of
a leaf a rank holds, and the collectives that move blocks, are in
``repro_torch/sharding.py``.

No function here starts a process group. Start one first, for example
under ``torchrun`` (which sets ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``)::

    torch.distributed.init_process_group("nccl")    # GPUs; "gloo": CPU

or in one process::

    torch.distributed.init_process_group(
        "nccl", init_method="tcp://127.0.0.1:29500", rank=0, world_size=1)
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.core.executor import resolve_device
from repro_torch.sharding import (MeshShape, axis_sizes, block_range,
                                  block_shape, entry_axes)

#: the process-group backend each device type needs
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}

BATCH = ("pod", "data")
FSDP = "data"
TP = "model"


def require_group(device, what: str) -> torch.device:
    """``device`` resolved; raises unless a process group is initialized
    with the backend that device type needs (``what`` names the caller
    in the message)."""
    dev = resolve_device(device)
    want = BACKENDS.get(dev.type)
    if want is None:
        raise ValueError(f"no spmd backend for device type {dev.type!r}")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"{what} needs an initialized process group and starts "
            f"none: call torch.distributed.init_process_group({want!r}) "
            "first (torchrun sets its rank, world size and address), or "
            f"init_process_group({want!r}, init_method='tcp://127.0.0.1:"
            "<port>', rank=0, world_size=1) in one process")
    backend = str(dist.get_backend())
    if want not in backend:
        raise RuntimeError(f"the process group runs {backend!r}; spmd on "
                           f"{dev.type} needs {want!r}")
    return dev


def make_data_mesh(device=None):
    """1-D ``DeviceMesh`` named ``("data",)`` over the initialized
    process group, on CUDA unless ``device="cpu"`` is asked for. The
    group's backend must be NCCL on CUDA and gloo on the CPU; without
    an initialized group this raises and says how to start one."""
    from torch.distributed.device_mesh import DeviceMesh
    dev = require_group(device, "make_data_mesh")
    world = dist.get_world_size()
    return DeviceMesh(dev.type, torch.arange(world),
                      mesh_dim_names=("data",))


# ---------------------------------------------------------------------------
# The LM mesh
# ---------------------------------------------------------------------------

def _default_names(ndim: int) -> tuple[str, ...]:
    return {2: ("data", "model"), 3: ("pod", "data", "model")}[ndim]


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return MeshShape(shape, _default_names(len(shape)))


def make_mesh(shape: tuple[int, ...], device=None):
    """``DeviceMesh`` of ``shape`` (``("data", "model")``, or
    ``("pod", "data", "model")`` for three dims) over the first
    prod(shape) ranks of the initialized group, on CUDA unless
    ``device="cpu"``; raises without a group of the right backend."""
    from torch.distributed.device_mesh import DeviceMesh
    dev = require_group(device, "make_mesh")
    shape = tuple(int(n) for n in shape)
    names = _default_names(len(shape))
    n = math.prod(shape)
    if n > dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {n} ranks; the group has "
                         f"{dist.get_world_size()}")
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_host_mesh(num_devices: int | None = None, device=None):
    """``(n, 1)`` ``("data", "model")`` mesh over the initialized group
    (``n``: its world size unless given), NCCL on CUDA and gloo on the
    CPU; raises without a group, as ``make_data_mesh`` does."""
    require_group(device, "make_host_mesh")
    n = num_devices or dist.get_world_size()
    return make_mesh((n, 1), device)


def _axis_size(mesh, name) -> int:
    if isinstance(name, tuple):
        return math.prod(_axis_size(mesh, n) for n in name)
    sizes = axis_sizes(mesh)
    if name is None or name not in sizes:
        return 1
    return sizes[name]


def _sh(mesh, dim: int, name):
    """Axis name if it exists in the mesh and divides dim, else None."""
    if name is None:
        return None
    names_in = axis_sizes(mesh)
    if isinstance(name, tuple):
        names = tuple(n for n in name if n in names_in)
        if not names:
            return None
        if dim % _axis_size(mesh, names) == 0:
            return names if len(names) > 1 else names[0]
        # try prefixes (e.g. batch too small for pod*data -> data only)
        for k in range(len(names) - 1, 0, -1):
            if dim % _axis_size(mesh, names[:k]) == 0:
                return names[:k] if k > 1 else names[0]
        return None
    if name not in names_in:
        return None
    return name if dim % _axis_size(mesh, name) == 0 else None


def _param_spec(path: str, shape: tuple[int, ...], mesh) -> tuple:
    """Name-based sharding rule for one parameter leaf (the reference's
    rule with no leading K dim: a port layer leaf is one layer's)."""
    s = partial(_sh, mesh)
    name = path.split("/")[-1]

    def spec(*names):
        full = list(names)[:len(shape)]
        full += [None] * (len(shape) - len(full))
        return tuple(s(shape[i], full[i]) for i in range(len(shape)))

    if name == "embed":
        return spec(TP, FSDP)
    if name == "lm_head":
        return spec(FSDP, TP)
    if name == "frontend_proj":
        return spec(None, FSDP)
    if name in ("wq", "wk", "wv", "wz", "wx", "wi_gate", "wi_up", "wi",
                "w_gate", "wdt"):
        if "moe" in path and name in ("wi_gate", "wi_up"):
            return spec(TP, FSDP, None)     # (E, d, ff): EP over model
        return spec(FSDP, TP)
    if name == "wo":
        if "moe" in path:
            return spec(TP, None, FSDP)     # (E, ff, d)
        return spec(TP, FSDP)
    if name in ("wB", "wC"):
        return spec(FSDP, None)
    if name == "router":
        return spec(FSDP, None)
    if name == "conv_w":
        return spec(None, TP)
    if name in ("dt_bias", "a_log", "D"):
        return spec(TP)
    # norms, biases, small vectors: replicated
    return (None,) * len(shape)


def map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a tree of dicts and lists (paths joined by
    "/", list items by index), in the tree's structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, f"{prefix}{i}/")
                for i, v in enumerate(tree)]
    return fn(prefix.rstrip("/"), tree)


def zip_specs(tree, specs):
    """(leaf, spec) pairs in ``model._leaves`` order, the spec tree
    walked by the tree's own keys (its key order may differ)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from zip_specs(v, specs[k])
    elif isinstance(tree, (list, tuple)):
        for v, s in zip(tree, specs):
            yield from zip_specs(v, s)
    else:
        yield tree, specs


def param_specs(cfg, mesh, abstract_params=None):
    """Spec tree matching the parameter tree (``model.abstract_params``
    unless given)."""
    from repro_torch.models.model import abstract_params as abs_p
    tree = abstract_params if abstract_params is not None else abs_p(cfg)
    return map_with_path(lambda p, t: _param_spec(p, tuple(t.shape), mesh),
                         tree)


def opt_specs(ps) -> dict:
    """Optimizer state's specs from the parameters' (``param_specs``):
    m/v shadow the param tree; step replicated."""
    return {"step": (), "m": ps, "v": ps}


def batch_specs(cfg, mesh, batch_tree) -> Any:
    """Batch leaves shard their batch dim over (pod, data): the leading
    dim, or dim 1 of the M-RoPE ``positions`` (3, B, S). Decode's
    ``tokens`` (B, 1) and ``kv_len`` (B,) take the same rule."""
    def one(path, leaf):
        name = path.split("/")[-1]
        shape = tuple(leaf.shape)
        if name == "positions":          # (3, B, S)
            return (None, _sh(mesh, shape[1], BATCH), None)
        return (_sh(mesh, shape[0], BATCH),) + (None,) * (len(shape) - 1)

    return map_with_path(one, batch_tree)


def cache_specs(cfg, mesh, cache_tree) -> Any:
    """Decode caches, one dict per layer. Attention k/v: (B, Smax, Hkv,
    hd) — batch over (pod, data), sequence over model (split-K decode).
    If batch can't use the data axis (long_500k b=1), sequence takes
    (data, model). Mamba-2: conv (B, W, C) channels over model, ssm
    (B, H, N, P) heads over model."""
    names_in = axis_sizes(mesh)

    def one(path, leaf):
        name = path.split("/")[-1]
        shape = tuple(leaf.shape)
        if name in ("k", "v"):
            b_ax = _sh(mesh, shape[0], BATCH)
            used = set()
            if b_ax is not None:
                used = set(b_ax) if isinstance(b_ax, tuple) else {b_ax}
            seq_axes = tuple(a for a in ("data", "model")
                             if a in names_in and a not in used)
            s_ax = _sh(mesh, shape[1], seq_axes if len(seq_axes) > 1
                       else (seq_axes[0] if seq_axes else None))
            return (b_ax, s_ax, None, None)
        if name == "conv":               # (B, W, C)
            return (_sh(mesh, shape[0], BATCH), None,
                    _sh(mesh, shape[2], TP))
        if name == "ssm":                # (B, H, N, Pd)
            return (_sh(mesh, shape[0], BATCH), _sh(mesh, shape[1], TP),
                    None, None)
        raise ValueError(name)

    return map_with_path(one, cache_tree)


def seq_range(spec: tuple, mesh, coords, smax: int) -> tuple[int, int]:
    """The slots [lo, hi) of a (B, Smax, Hkv, D) cache's sequence that
    the rank at mesh coordinates ``coords`` holds under ``spec``
    (``cache_specs``' k/v spec): the block offsets of the split-K decode's
    slice; (0, Smax) where the sequence stays whole."""
    sizes = axis_sizes(mesh)
    return block_range(smax, spec[1], sizes, dict(zip(sizes, coords)))


# ---------------------------------------------------------------------------
# Blocks (``repro_torch/sharding.py``): their bytes and DTensor placements
# ---------------------------------------------------------------------------

def block_bytes(tree, specs, mesh) -> int:
    """Bytes of one rank's blocks of every leaf of ``tree`` (meta
    tensors will do): its per-device argument bytes."""
    return sum(math.prod(block_shape(t.shape, s, mesh)) * t.element_size()
               for t, s in zip_specs(tree, specs))


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of a spec on a mesh, one per mesh dim:
    ``Shard(d)`` where the mesh axis splits tensor dim d, else
    ``Replicate()``. A dim over several axes gets ``Shard(d)`` on each;
    DTensor splits such a dim over the mesh dims in their order, so
    the spec must list them in that order (major first, as JAX does)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_sizes(mesh))
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec {spec}: axes {axes} are not in the "
                             f"mesh's order {tuple(names)}")
        for a in axes:
            out[names.index(a)] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSpec:
    """A spec on a mesh (the reference's ``NamedSharding``): where a
    leaf's blocks live. ``checkpoint.restore(..., shardings=)`` takes
    a tree of these."""
    mesh: Any
    spec: tuple


def named(mesh, spec_tree):
    """The spec tree with each spec paired with ``mesh``."""
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [named(mesh, v) for v in spec_tree]
    return NamedSpec(mesh, spec_tree)
