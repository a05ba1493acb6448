"""Fault-tolerant checkpointing: atomic, async, restore onto a device,
ported from ``repro/checkpoint/manager.py``.

* **Atomic two-phase commit** — write into ``step_N.tmp/``, fsync,
  rename to ``step_N/``; a crash mid-write never corrupts the latest
  complete checkpoint, and ``latest_step`` only sees committed dirs.
* **Async save** — the device-to-host copy happens on the caller's
  thread, the write on a background thread; the train loop only blocks
  on the *previous* save (one outstanding), hiding I/O behind compute.
* **Restore onto a device or a mesh** — arrays are stored whole
  (numpy) with the tree's paths, so a checkpoint restores into any tree
  of the same structure, on the device the caller names (``device=``),
  and with ``shardings=`` (a tree, or a prefix of one, of
  ``launch.mesh.NamedSpec`` or None) as each rank's blocks of a mesh:
  a checkpoint written on one mesh restores on any other, or in one
  process. This is what makes restore elastic across mesh changes.
* **Sharded save** — ``save(..., shardings=)`` of a tree of blocks
  gathers each leaf whole (every rank of the mesh takes part), the
  mesh's first rank writes, and then every rank learns whether the
  write was committed (``sharding.all_ranks_ok``): a failed write
  raises on every rank, in ``save`` and at ``save_async``'s next
  ``wait``. The file format is the unsharded one.
* **Self-describing** — ``metadata.json`` carries step, timestamp, the
  caller's extra keys and the flattened tree's paths.

The layout is the JAX package's: ``arrays.npz`` with ``leaf_<i>`` in
tree order (dict keys sorted, lists and tuples in order, as
``jax.tree_util`` flattens) and ``metadata.json``. bfloat16 leaves are
stored as float32 (numpy has no bfloat16) and cast back on restore.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import sharding


def _flatten(tree, prefix: tuple = ()) -> list[tuple[str, Any]]:
    """(path, leaf) pairs in ``jax.tree_util`` order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], prefix + (str(k),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, prefix + (str(i),))
        return out
    return [("/".join(prefix), tree)]


def _unflatten(like, leaves: list):
    """``like``'s structure with its leaves replaced, in ``_flatten``
    order."""
    it = iter(leaves)

    def rec(t):
        if isinstance(t, dict):
            vals = {k: rec(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(rec(v) for v in t)
        return next(it)

    return rec(like)


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        # a copy even on the CPU: the caller may update the leaf in place
        # while a background save writes it
        t = leaf.detach().to("cpu", copy=True)
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def _broadcast_prefix(prefix: Any, full: Any) -> list:
    """Flatten ``prefix`` against ``full``'s structure (``_flatten``
    order), broadcasting leaf values (``NamedSpec`` or None) over whole
    subtrees — so callers can pass e.g. {"params": spec_tree, "opt":
    None}."""
    out: list = []

    def rec(p, f):
        if p is None or not isinstance(p, (dict, list, tuple)):
            out.extend([p] * len(_flatten(f)))
        elif isinstance(p, dict) and isinstance(f, dict):
            for k in sorted(f):
                rec(p[k], f[k])
        elif isinstance(p, (list, tuple)) and isinstance(f, (list, tuple)):
            for a, b in zip(p, f):
                rec(a, b)
        else:
            raise TypeError(f"sharding prefix mismatch: {type(p)} vs "
                            f"{type(f)}")

    rec(prefix, full)
    return out


class _Mesh:
    """What a sharded save or restore needs of the mesh of its specs:
    this rank's coordinates, the axis groups, whether it writes, and
    whether the writer committed."""

    def __init__(self, specs: list):
        meshes = {id(ns.mesh): ns.mesh for ns in specs if ns is not None}
        if len(meshes) != 1:
            raise ValueError(f"shardings name {len(meshes)} meshes; one "
                             "is needed")
        (self.mesh,) = meshes.values()
        coords = self.mesh.get_coordinate()
        if coords is None:
            raise RuntimeError("this rank is not in the shardings' mesh")
        self.coords = tuple(coords)
        self.sizes = sharding.axis_sizes(self.mesh)
        self.groups = sharding.mesh_groups(self.mesh)
        self.writer = not any(self.coords)

    def gather(self, leaf, ns):
        if ns is None or not isinstance(leaf, torch.Tensor):
            return leaf
        return sharding.gather_block(leaf.detach(), ns.spec, self.sizes,
                                     self.groups)

    def committed(self, ok: bool) -> None:
        """Every rank waits for the writer, and raises unless it
        committed (``ok``: this rank's own part went well; the writer
        re-raises its own error instead)."""
        if not sharding.all_ranks_ok(ok, self.groups,
                                     self.mesh.device_type) and ok:
            raise RuntimeError("the checkpoint was not committed: its "
                               "writer, the mesh's first rank, failed")


def _host_leaves(tree: Any, shardings: Any):
    """(the host copies of ``tree``'s leaves, or None on a rank that does
    not write; the mesh, or None unsharded)."""
    flat = _flatten(tree)
    if shardings is None:
        return [_to_host(leaf) for _, leaf in flat], None
    specs = _broadcast_prefix(shardings, tree)
    mesh = _Mesh(specs)
    host = []
    for (_, leaf), ns in zip(flat, specs):
        whole = mesh.gather(leaf, ns)
        if mesh.writer:
            host.append(_to_host(whole))
    return (host if mesh.writer else None), mesh


def save(directory: str, step: int, tree: Any, *,
         extra_meta: Optional[dict] = None,
         shardings: Any = None) -> str:
    """Blocking atomic save of a tree of tensors or arrays. Returns the
    committed directory. ``shardings``: the tree is this rank's blocks
    (module docstring); every rank of the mesh calls this."""
    host, mesh = _host_leaves(tree, shardings)
    try:
        if host is not None:
            _write(directory, step, [p for p, _ in _flatten(tree)], host,
                   extra_meta)
    except BaseException:
        if mesh is not None:
            mesh.committed(False)
        raise
    if mesh is not None:
        mesh.committed(True)
    return os.path.join(directory, f"step_{step:08d}")


def _write(directory: str, step: int, paths: list, host_leaves: list,
           extra_meta: Optional[dict]) -> None:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"leaf_{i}": a for i, a in enumerate(host_leaves)})
    meta = {"step": step, "time": time.time(),
            "num_leaves": len(host_leaves),
            "paths": paths,
            **(extra_meta or {})}
    with open(os.path.join(tmp, "metadata.json"), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)      # atomic commit


def latest_step(directory: str) -> Optional[int]:
    """Largest committed step (ignores .tmp partials)."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp") \
                and os.path.exists(os.path.join(directory, name,
                                                "metadata.json")):
            steps.append(int(name[5:]))
    return max(steps) if steps else None


def restore(directory: str, step: int, like: Any, device=None,
            shardings: Any = None) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors, meta
    ones included): each leaf in its ``like`` leaf's dtype, on
    ``device`` (``None``: the ``like`` leaf's own device). With
    ``shardings`` (a tree or prefix of ``NamedSpec`` or None), a leaf
    with a spec becomes this rank's block of the stored array, and its
    ``like`` leaf has the block's shape. Leaves are read one at a time."""
    path = os.path.join(directory, f"step_{step:08d}")
    like_leaves = [leaf for _, leaf in _flatten(like)]
    specs = (_broadcast_prefix(shardings, like) if shardings is not None
             else [None] * len(like_leaves))
    mesh = _Mesh(specs) if shardings is not None else None
    out = []
    with np.load(os.path.join(path, "arrays.npz")) as z:
        if len(z.files) != len(like_leaves):
            raise ValueError(f"checkpoint has {len(z.files)} leaves, "
                             f"target needs {len(like_leaves)}")
        for i, (want, ns) in enumerate(zip(like_leaves, specs)):
            got = z[f"leaf_{i}"]
            shape = (tuple(got.shape) if ns is None
                     else sharding.block_shape(got.shape, ns.spec,
                                               ns.mesh))
            if shape != tuple(want.shape):
                raise ValueError(f"shape mismatch {got.shape} "
                                 f"({ns.spec if ns else 'whole'}) vs "
                                 f"{tuple(want.shape)}")
            t = torch.from_numpy(got)
            if ns is not None:
                t = sharding.block(t, ns.spec, ns.mesh, mesh.coords)
                if t.numel() != got.size:
                    t = t.clone()
            out.append(t.to(device=device if device is not None
                            else want.device, dtype=want.dtype))
    return _unflatten(like, out)


class CheckpointManager:
    """Async manager with bounded retention and one outstanding save."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._mesh: Optional[_Mesh] = None

    def wait(self) -> None:
        """Until the outstanding save is committed; raises if it failed
        (on a mesh, on every rank: each waits for the writer)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        mesh, self._mesh = self._mesh, None
        err, self._error = self._error, None
        if mesh is not None:
            mesh.committed(err is None)
        if err is not None:
            raise err

    def save_async(self, step: int, tree: Any,
                   extra_meta: Optional[dict] = None,
                   shardings: Any = None) -> None:
        """``save`` in the background. The device-to-host copy (and on a
        mesh the gathers) runs on the caller's thread: the tree may be
        updated in place by the next step."""
        self.wait()                       # one outstanding save
        host, self._mesh = _host_leaves(tree, shardings)
        if host is None:                  # a rank of a mesh that does
            return                        # not write
        paths = [p for p, _ in _flatten(tree)]

        def work():
            try:
                _write(self.directory, step, paths, host, extra_meta)
                self._gc()
            except BaseException as e:     # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self) -> None:
        steps = sorted(
            int(n[5:]) for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory,
                                       f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, like: Any, device=None, shardings: Any = None
                       ) -> tuple[Optional[int], Any]:
        self.wait()
        step = latest_step(self.directory)
        if step is None:
            return None, like
        return step, restore(self.directory, step, like, device, shardings)
