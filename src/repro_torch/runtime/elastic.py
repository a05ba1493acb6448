"""Elastic re-meshing after node loss, ported from
``repro/runtime/elastic.py``: ``remesh_plan`` is a copy;
``build_mesh_from_plan`` builds a torch ``DeviceMesh``, over a subgroup
of the surviving ranks where the plan uses fewer than the world.

On failure/straggler exclusion the driver: (1) stops issuing steps,
(2) computes a new mesh over surviving hosts (largest power-of-two
data axis that preserves the model axis), (3) restores the latest
checkpoint (checkpoint.restore is mesh-agnostic: arrays are stored
whole), and (4) resumes. Because the global batch is fixed, the data
axis shrink raises per-device batch — remesh_plan reports the new
microbatching so the step function is rebuilt consistently.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class ElasticState:
    num_hosts: int
    devices_per_host: int
    model_axis: int
    data_axis: int

    @property
    def num_devices(self) -> int:
        return self.num_hosts * self.devices_per_host


def _largest_pow2_leq(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def remesh_plan(state: ElasticState, surviving_hosts: list[int],
                global_batch: int, microbatches: int
                ) -> Optional[dict]:
    """New mesh shape + microbatching after losing hosts.

    Keeps the model axis (TP degree is a property of the checkpointed
    layout's math, though restore could change it too); shrinks the
    data axis to the largest power of two that the surviving devices
    support. Returns None if nothing survives.
    """
    n_dev = len(surviving_hosts) * state.devices_per_host
    if n_dev < state.model_axis:
        return None
    new_data = _largest_pow2_leq(n_dev // state.model_axis)
    used = new_data * state.model_axis
    # fixed global batch: per-device batch grows; raise microbatches
    # by the shrink factor to keep activation memory flat
    shrink = max(state.data_axis // new_data, 1)
    new_micro = microbatches * shrink
    while global_batch % (new_data * new_micro):
        new_micro += 1
    return {
        "mesh_shape": (new_data, state.model_axis),
        "axis_names": ("data", "model"),
        "devices_used": used,
        "hosts": sorted(surviving_hosts),
        "microbatches": new_micro,
        "per_device_batch": global_batch // new_data,
    }


def build_mesh_from_plan(plan: dict, device_type: str = "cuda"):
    """The plan's (data, model) mesh as a ``DeviceMesh`` of the
    initialized ``torch.distributed`` group (the JAX version takes the
    first devices of ``jax.devices()``): over the first data x model
    of the plan's surviving ``hosts``, a host being one rank (torchrun
    starts one process a device), or of the whole group for a plan
    without ``hosts``. Where that is fewer ranks than the world, the
    mesh lives on a subgroup: every rank of the group calls this (the
    groups are made collectively), and a rank outside the mesh gets one
    whose ``get_coordinate()`` is None."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    shape = tuple(plan["mesh_shape"])
    n = shape[0] * shape[1]
    ranks = list(plan["hosts"])[:n] if "hosts" in plan else list(range(n))
    if len(ranks) < n:
        raise ValueError(f"plan {shape} needs {n} ranks; the surviving "
                         f"hosts hold {len(ranks)}")
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=tuple(plan["axis_names"]))
