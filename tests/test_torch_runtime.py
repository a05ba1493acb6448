"""The port's runtime (``repro_torch.runtime``): the straggler monitor and
the re-mesh plan as tests/test_runtime.py holds the JAX package's, and
int8 gradient compression with error feedback over a two-rank gloo
group against the JAX package's ``compressed_mean`` under ``vmap`` on
the same gradients (the compression test of tests/test_distributed.py).

The two ranks are subprocesses that meet through a file store in the
test's tmp dir (no port to race for) and have their own timeout.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.runtime import (ElasticState, StragglerMonitor,
                                 remesh_plan)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
GROUP_TIMEOUT_S = 120
STEPS, SHAPE = 6, (64,)
EF_ATOL = 1e-6     # far below one quantum (the scale, ~0.025): equal codes


def test_straggler_flags_slow_host():
    hits = []
    mon = StragglerMonitor(num_hosts=4, patience=3,
                           on_straggler=lambda h, t: hits.append(h))
    for step in range(20):
        for h in range(4):
            t = 1.0 + 0.01 * np.sin(step + h)
            if h == 2 and step >= 8:
                t = 3.0          # host 2 degrades
            mon.record(h, t)
    assert mon.flagged == {2}
    assert hits == [2]
    assert mon.healthy_hosts() == [0, 1, 3]


def test_straggler_recovers():
    mon = StragglerMonitor(num_hosts=2, patience=2)
    for step in range(10):
        mon.record(0, 1.0)
        mon.record(1, 4.0 if 3 <= step <= 5 else 1.0)
    assert 1 not in mon.flagged     # recovered -> unflagged


def test_remesh_plan_shrinks_data_axis():
    st = ElasticState(num_hosts=8, devices_per_host=4, model_axis=4,
                      data_axis=8)
    plan = remesh_plan(st, surviving_hosts=[0, 1, 2, 3, 4, 6],
                       global_batch=256, microbatches=2)
    assert plan["mesh_shape"][1] == 4            # model axis preserved
    assert plan["mesh_shape"][0] * 4 <= 6 * 4    # fits survivors
    assert 256 % (plan["mesh_shape"][0] * plan["microbatches"]) == 0


def test_remesh_plan_impossible():
    st = ElasticState(num_hosts=4, devices_per_host=1, model_axis=4,
                      data_axis=1)
    assert remesh_plan(st, surviving_hosts=[0], global_batch=8,
                       microbatches=1) is None


def test_remesh_plan_matches_jax():
    from repro.runtime import ElasticState as JaxState
    from repro.runtime import remesh_plan as jax_plan
    for hosts in ([0, 1, 2, 3, 4, 6], [0, 1, 2], [5]):
        kw = dict(num_hosts=8, devices_per_host=4, model_axis=4,
                  data_axis=8)
        assert remesh_plan(ElasticState(**kw), hosts, 256, 2) == \
            jax_plan(JaxState(**kw), hosts, 256, 2)


RANK_SCRIPT = r'''
import os, pickle, sys
from datetime import timedelta
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.runtime import ErrorFeedback, compressed_mean
from repro_torch.runtime.elastic import build_mesh_from_plan

rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
out = os.environ["OUT"]
dist.init_process_group("gloo", init_method="file://" + os.path.join(out, "store"),
                        rank=rank, world_size=world, timeout=timedelta(seconds=90))
with open(os.path.join(out, "grads.pkl"), "rb") as f:
    grads, uniform = pickle.load(f)
res = {"means": [], "resid": []}
ef = ErrorFeedback.init({"g": torch.zeros(grads.shape[2:])})
for t in range(grads.shape[0]):
    mean, ef = compressed_mean({"g": torch.from_numpy(grads[t, rank])}, ef)
    res["means"].append(mean["g"].numpy())
    res["resid"].append(ef.residual["g"].numpy())
mean, _ = compressed_mean({"g": torch.from_numpy(uniform)},
                          ErrorFeedback.init({"g": torch.zeros(3)}))
res["uniform"] = mean["g"].numpy()
mesh = build_mesh_from_plan({"mesh_shape": (world, 1),
                             "axis_names": ("data", "model")}, "cpu")
res["mesh"] = (tuple(mesh.mesh.shape), mesh.mesh_dim_names)
with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(res, f)
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    """Each rank's compressed means and residuals over STEPS steps of
    seeded gradients, its mean of a uniform gradient and its mesh."""
    out = tmp_path_factory.mktemp("compression")
    rng = np.random.default_rng(0)
    grads = rng.normal(size=(STEPS, WORLD) + SHAPE).astype(np.float32)
    uniform = np.asarray([1.27, -0.635, 0.0], np.float32)
    with open(out / "grads.pkl", "wb") as f:
        pickle.dump((grads, uniform), f)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               WORLD_SIZE=str(WORLD), OUT=str(out))
    procs, logs = [], []
    for r in range(WORLD):
        logs.append(open(out / f"rank{r}.log", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_SCRIPT], stdout=logs[-1],
            stderr=subprocess.STDOUT, env=dict(env, RANK=str(r))))
    try:
        for p in procs:
            p.wait(timeout=GROUP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"gloo ranks did not finish in {GROUP_TIMEOUT_S} s")
    finally:
        for fh in logs:
            fh.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (out / f"rank{r}.log").read_text()[-4000:]
    ranks = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return grads, uniform, ranks


def test_compressed_mean_error_feedback(gloo_ranks):
    """Int8+EF mean over the ranks: biased per step, but the error
    feedback keeps the *accumulated* average unbiased; every rank gets
    the same mean."""
    grads, _, ranks = gloo_ranks
    for r in ranks[1:]:
        for a, b in zip(r["means"], ranks[0]["means"]):
            np.testing.assert_array_equal(a, b)
    acc_c = np.sum(ranks[0]["means"], axis=0)
    acc_t = grads.mean(1).sum(0)
    rel = np.abs(acc_c - acc_t).mean() / (np.abs(acc_t).mean() + 1e-6)
    assert rel < 0.05, rel


def test_compressed_mean_matches_jax(gloo_ranks):
    """The same steps through the JAX package's compressed_mean under
    vmap over a two-shard axis: the same int8 codes (so means within a
    last bit of the scale) and residuals within EF_ATOL. XLA may divide
    by 127 as a multiply by its reciprocal: a last-bit difference in the
    scale, which |q| <= 127 carries into the approximation and the
    feedback carries from step to step."""
    import jax
    import jax.numpy as jnp
    from repro.runtime import ErrorFeedback as JaxEF
    from repro.runtime import compressed_mean as jax_cm
    grads, _, ranks = gloo_ranks

    def one_step(g, r):
        out, ef = jax_cm({"g": g}, JaxEF(residual={"g": r}), axis="pod")
        return out["g"], ef.residual["g"]

    step = jax.jit(jax.vmap(one_step, axis_name="pod"))
    resid = jnp.zeros((WORLD,) + SHAPE, jnp.float32)
    for t in range(STEPS):
        mean, resid = step(jnp.asarray(grads[t]), resid)
        for r in range(WORLD):
            np.testing.assert_allclose(ranks[r]["means"][t],
                                       np.asarray(mean[r]), rtol=0,
                                       atol=EF_ATOL)
            np.testing.assert_allclose(ranks[r]["resid"][t],
                                       np.asarray(resid[r]), rtol=0,
                                       atol=EF_ATOL)


def test_compressed_mean_exact_for_uniform(gloo_ranks):
    """All ranks equal -> compression is exact (quantization grid
    aligned by the shared max scale)."""
    _, uniform, ranks = gloo_ranks
    for r in ranks:
        np.testing.assert_allclose(r["uniform"], uniform, atol=1e-2)


def test_build_mesh_from_plan(gloo_ranks):
    _, _, ranks = gloo_ranks
    for r in ranks:
        assert r["mesh"] == ((WORLD, 1), ("data", "model"))
