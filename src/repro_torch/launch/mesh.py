"""The "data" mesh of spmd query execution.

``make_data_mesh`` is the counterpart of the JAX package's
``compat.make_mesh((n,), ("data",))`` (and of ``launch/mesh.py``'s
``make_host_mesh``): a 1-D ``torch.distributed`` ``DeviceMesh`` named
``("data",)`` over every rank of the process group that is already
initialized, one partition of the database a rank
(``Executor.compile(mode="spmd", mesh=...)``).

It never starts a group of its own. Start one first, for example
under ``torchrun`` (which sets ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``)::

    torch.distributed.init_process_group("nccl")    # GPUs; "gloo": CPU

or in one process::

    torch.distributed.init_process_group(
        "nccl", init_method="tcp://127.0.0.1:29500", rank=0, world_size=1)
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.executor import resolve_device

#: the process-group backend each device type needs
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def make_data_mesh(device=None):
    """1-D ``DeviceMesh`` named ``("data",)`` over the initialized
    process group, on CUDA unless ``device="cpu"`` is asked for. The
    group's backend must be NCCL on CUDA and gloo on the CPU; without
    an initialized group this raises and says how to start one."""
    from torch.distributed.device_mesh import DeviceMesh
    dev = resolve_device(device)
    want = BACKENDS.get(dev.type)
    if want is None:
        raise ValueError(f"no spmd backend for device type {dev.type!r}")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_data_mesh needs an initialized process group and starts "
            f"none: call torch.distributed.init_process_group({want!r}) "
            "first (torchrun sets its rank, world size and address), or "
            f"init_process_group({want!r}, init_method='tcp://127.0.0.1:"
            "<port>', rank=0, world_size=1) in one process")
    backend = str(dist.get_backend())
    if want not in backend:
        raise RuntimeError(f"the process group runs {backend!r}; spmd on "
                           f"{dev.type} needs {want!r}")
    world = dist.get_world_size()
    return DeviceMesh(dev.type, torch.arange(world),
                      mesh_dim_names=("data",))
