"""Fault-tolerant checkpointing: atomic, async, restore onto a device,
ported from ``repro/checkpoint/manager.py``.

* **Atomic two-phase commit** — write into ``step_N.tmp/``, fsync,
  rename to ``step_N/``; a crash mid-write never corrupts the latest
  complete checkpoint, and ``latest_step`` only sees committed dirs.
* **Async save** — the device-to-host copy happens on the caller's
  thread, the write on a background thread; the train loop only blocks
  on the *previous* save (one outstanding), hiding I/O behind compute.
* **Restore onto a device** — arrays are stored whole (numpy) with the
  tree's paths, so a checkpoint restores into any tree of the same
  structure, on the device the caller names (``device=``; the JAX
  package's ``shardings`` place shards on a mesh instead: a sharded
  restore waits for a multi-card slice).
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


def save(directory: str, step: int, tree: Any, *,
         extra_meta: Optional[dict] = None) -> str:
    """Blocking atomic save of a tree of tensors or arrays. Returns the
    committed directory."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten(tree)
    host_leaves = [_to_host(leaf) for _, leaf in flat]
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"leaf_{i}": a for i, a in enumerate(host_leaves)})
    meta = {"step": step, "time": time.time(),
            "num_leaves": len(host_leaves),
            "paths": [path for path, _ in flat],
            **(extra_meta or {})}
    with open(os.path.join(tmp, "metadata.json"), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)      # atomic commit
    return final


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


def restore(directory: str, step: int, like: Any, device=None) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors): each
    leaf in its ``like`` leaf's dtype, on ``device`` (``None``: the
    ``like`` leaf's own device)."""
    path = os.path.join(directory, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
    like_leaves = [leaf for _, leaf in _flatten(like)]
    if len(leaves) != len(like_leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, "
                         f"target needs {len(like_leaves)}")
    for got, want in zip(leaves, like_leaves):
        if tuple(got.shape) != tuple(want.shape):
            raise ValueError(f"shape mismatch {got.shape} vs "
                             f"{tuple(want.shape)}")
    out = [torch.from_numpy(a).to(device=device if device is not None
                                   else want.device, dtype=want.dtype)
           for a, want in zip(leaves, like_leaves)]
    return _unflatten(like, out)


class CheckpointManager:
    """Async manager with bounded retention and one outstanding save."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree: Any,
                   extra_meta: Optional[dict] = None) -> None:
        self.wait()                       # one outstanding save
        # the device-to-host copy on the caller's thread: the tree may be
        # updated in place by the next step
        host = _unflatten(tree, [_to_host(leaf) for _, leaf in
                                 _flatten(tree)])

        def work():
            try:
                save(self.directory, step, host, extra_meta=extra_meta)
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

    def restore_latest(self, like: Any, device=None
                       ) -> tuple[Optional[int], Any]:
        self.wait()
        step = latest_step(self.directory)
        if step is None:
            return None, like
        return step, restore(self.directory, step, like, device)
