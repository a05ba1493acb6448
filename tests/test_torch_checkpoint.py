"""The port's checkpoint manager (``repro_torch.checkpoint``) and the
training driver's resume, as tests/test_checkpoint.py holds the JAX
package's: atomicity, resume, async saves, retention, restore onto a
device, metadata; and the layout against the JAX package's own files.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (CheckpointManager, latest_step, restore,
                                    save)
from repro_torch.checkpoint.manager import _flatten


def tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "blocks": (torch.ones((2, 2)), torch.zeros((2,)))},
            "step": torch.tensor(7, dtype=torch.int32)}


def leaves(t):
    return [leaf for _, leaf in _flatten(t)]


def zeros_like(t):
    return {"params": {"w": torch.zeros(3, 4),
                       "blocks": (torch.zeros(2, 2), torch.ones(2))},
            "step": torch.tensor(0, dtype=torch.int32)}


def test_save_restore_roundtrip(tmp_path):
    t = tree()
    save(str(tmp_path), 5, t)
    assert latest_step(str(tmp_path)) == 5
    got = restore(str(tmp_path), 5, zeros_like(t))
    assert isinstance(got["params"]["blocks"], tuple)
    for a, b in zip(leaves(got), leaves(t)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_partial_write_is_invisible(tmp_path):
    """A crash mid-save (leftover .tmp) must not surface as latest."""
    save(str(tmp_path), 1, tree())
    os.makedirs(tmp_path / "step_00000002.tmp")
    (tmp_path / "step_00000002.tmp" / "garbage").write_text("x")
    assert latest_step(str(tmp_path)) == 1
    # an empty committed dir without metadata is also ignored
    os.makedirs(tmp_path / "step_00000003")
    assert latest_step(str(tmp_path)) == 1


def test_shape_mismatch_rejected(tmp_path):
    save(str(tmp_path), 1, {"w": torch.ones((3, 3))})
    with pytest.raises(ValueError):
        restore(str(tmp_path), 1, {"w": torch.ones((4, 4))})
    with pytest.raises(ValueError):
        restore(str(tmp_path), 1, {"w": torch.ones((3, 3)),
                                   "x": torch.ones(1)})


def test_async_manager_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (10, 20, 30):
        mgr.save_async(s, tree())
    mgr.wait()
    steps = sorted(int(n[5:]) for n in os.listdir(tmp_path)
                   if n.startswith("step_"))
    assert steps == [20, 30]


def test_async_save_copies_before_returning(tmp_path):
    """The host copy is taken on the caller's thread: an in-place update
    right after save_async does not reach the file."""
    mgr = CheckpointManager(str(tmp_path))
    t = tree()
    mgr.save_async(1, t)
    t["params"]["w"].add_(100.0)
    mgr.wait()
    got = restore(str(tmp_path), 1, zeros_like(t))
    assert torch.equal(got["params"]["w"], torch.arange(12.0).reshape(3, 4))


def test_async_error_surfaces_on_wait(tmp_path):
    (tmp_path / "file").write_text("x")        # a file where a dir goes
    mgr = CheckpointManager(str(tmp_path / "file"))
    mgr.save_async(1, tree())
    with pytest.raises(OSError):
        mgr.wait()


def test_resume_training(tmp_path):
    """Kill/restart: a fresh run resumes from the committed step and
    reaches the same final state as an uninterrupted run."""
    from repro_torch.launch.train import train
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    kw = dict(steps=8, batch=2, seq=16, ckpt_every=4, device="cpu")
    full = train("qwen3-1.7b", ckpt_dir=d1, **kw)
    # interrupted at step 6 (after ckpt at 4) then resumed
    with pytest.raises(RuntimeError):
        train("qwen3-1.7b", ckpt_dir=d2, fail_at=6, **kw)
    assert latest_step(d2) == 4
    resumed = train("qwen3-1.7b", ckpt_dir=d2, **kw)
    assert int(resumed["opt"]["step"]) == 8
    for a, b in zip(leaves(full["params"]), leaves(resumed["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_restore_onto_a_device(tmp_path):
    """Restore places every leaf on the named device, in its target's
    dtype (bfloat16 is stored as float32)."""
    t = {"w": torch.arange(16.0).reshape(4, 4).to(torch.bfloat16),
         "n": torch.arange(3, dtype=torch.int32)}
    save(str(tmp_path), 2, t)
    got = restore(str(tmp_path), 2, t, device="cpu")
    assert got["w"].dtype == torch.bfloat16 and got["w"].device.type == "cpu"
    assert torch.equal(got["w"], t["w"]) and torch.equal(got["n"], t["n"])
    meta = torch.device("meta")
    got = restore(str(tmp_path), 2, t, device=meta)
    assert got["w"].device == meta


def test_metadata_contents(tmp_path):
    save(str(tmp_path), 3, tree(), extra_meta={"arch": "x"})
    with open(tmp_path / "step_00000003" / "metadata.json") as f:
        meta = json.load(f)
    assert meta["step"] == 3 and meta["arch"] == "x"
    assert meta["num_leaves"] == len(leaves(tree()))
    assert meta["paths"] == ["params/blocks/0", "params/blocks/1",
                             "params/w", "step"]


def test_layout_matches_jax_package(tmp_path):
    """The JAX package's save and the port's write the same leaves in the
    same order under the same paths, for the same tree."""
    import jax.numpy as jnp
    from repro.checkpoint import save as jax_save
    t = tree()
    jt = {"params": {"w": jnp.asarray(t["params"]["w"].numpy()),
                     "blocks": tuple(jnp.asarray(b.numpy())
                                     for b in t["params"]["blocks"])},
          "step": jnp.int32(7)}
    jax_save(str(tmp_path / "jax"), 1, jt)
    save(str(tmp_path / "port"), 1, t)
    metas, arrays = [], []
    for sub in ("jax", "port"):
        d = tmp_path / sub / "step_00000001"
        with open(d / "metadata.json") as f:
            metas.append(json.load(f))
        with np.load(d / "arrays.npz") as z:
            arrays.append([z[f"leaf_{i}"] for i in range(len(z.files))])
    assert metas[0]["paths"] == metas[1]["paths"]
    for a, b in zip(*arrays):
        np.testing.assert_array_equal(a, b)
    # and the port restores the JAX package's checkpoint
    got = restore(str(tmp_path / "jax"), 1, zeros_like(t))
    for a, b in zip(leaves(got), leaves(t)):
        assert torch.equal(a, b)
