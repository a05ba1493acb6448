"""Blocks of sharded leaves and the collectives that move them: what
``launch/mesh.py``'s spec rules, ``launch/fsdp.py`` and a sharded
``checkpoint`` all need of a mesh, and nothing of the model.

A spec is a plain tuple with one entry per tensor dim: ``None``, an
axis name, or a tuple of names, major first (the entries of a JAX
``PartitionSpec``). A mesh is a ``torch.distributed`` ``DeviceMesh``
with named axes, or a ``MeshShape`` (names and sizes, no devices) where
no collective runs.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis sizes and names without devices (the reference's
    ``AbstractMesh``): what spec computation and the pod-mesh dry run
    need."""
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    def size(self) -> int:
        return math.prod(self.shape)


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``MeshShape`` or a ``DeviceMesh``."""
    if isinstance(mesh, MeshShape):
        return dict(zip(mesh.axis_names, mesh.shape))
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh has no axis names")
    return dict(zip(names, tuple(mesh.shape)))


def entry_axes(entry) -> tuple[str, ...]:
    """The axis names of one spec entry, major first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_axes(spec: tuple) -> tuple[str, ...]:
    """Every axis a spec shards over."""
    return tuple(a for e in spec for a in entry_axes(e))


def block_shape(shape, spec: tuple, mesh) -> tuple[int, ...]:
    """The shape of each rank's block of a leaf of ``shape``."""
    sizes = axis_sizes(mesh)
    out = []
    for i, n in enumerate(shape):
        parts = math.prod(sizes[a] for a in entry_axes(spec[i])) \
            if i < len(spec) else 1
        if n % parts:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"into {parts} blocks ({spec})")
        out.append(n // parts)
    return tuple(out)


def block(full: torch.Tensor, spec: tuple, mesh, coords) -> torch.Tensor:
    """The block of ``full`` at mesh coordinates ``coords`` (one index
    per mesh axis, in the mesh's axis order): each dim over axes
    (a, b, ...) is split into size(a) * size(b) * ... equal blocks and
    the block's index is the coordinates of a, b, ... read major first
    (JAX's block order). A view of ``full``."""
    sizes = axis_sizes(mesh)
    coord = dict(zip(sizes, coords))
    out = full
    for i, entry in enumerate(spec):
        axes = entry_axes(entry)
        if not axes:
            continue
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + coord[a]
        n = full.shape[i] // math.prod(sizes[a] for a in axes)
        out = out.narrow(i, idx * n, n)
    return out


def mesh_groups(mesh) -> dict:
    """{axis name: its process group} for each axis of size > 1 of a
    ``DeviceMesh``."""
    return {a: mesh.get_group(a)
            for a, n in axis_sizes(mesh).items() if n > 1}


def gather_block(x: torch.Tensor, spec: tuple, sizes: dict,
                 groups: dict) -> torch.Tensor:
    """The whole leaf from each rank's block ``x`` (every rank of the
    mesh takes part): per split dim, gathered over its axes minor
    first, so the blocks are concatenated in the order ``block`` reads
    them. ``sizes``/``groups``: ``axis_sizes`` and ``mesh_groups`` of
    the mesh."""
    for d, entry in enumerate(spec):
        for a in reversed(entry_axes(entry)):
            if a not in groups:
                continue
            parts = [torch.empty_like(x) for _ in range(sizes[a])]
            dist.all_gather(parts, x.contiguous(), group=groups[a])
            x = torch.cat(parts, d)
    return x


def all_ranks_ok(ok: bool, groups: dict, device) -> bool:
    """Whether ``ok`` holds on every rank of a mesh, which each rank
    learns once all have called this: the flag's minimum, all-reduced
    over each axis's group in turn (``groups``: ``mesh_groups``;
    ``device``: the mesh's device type)."""
    flag = torch.tensor([int(ok)], dtype=torch.int32, device=device)
    for group in groups.values():
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
    return bool(flag.item())
