"""The port's sharded training (``repro_torch/launch/fsdp.py``, the LM
mesh of ``launch/mesh.py``, ``checkpoint`` with ``shardings``,
``runtime/elastic.build_mesh_from_plan``) on the CPU.

Four gloo ranks are spawned as ``tests/test_torch_spmd.py`` spawns
them (a free port, a 120 s limit, one log a rank). They train the smoke
configs of llama3-8b and mamba2-370m in float32 from the JAX package's
initial weights (carried by ``models/convert.py``) on (data, model)
meshes (2, 2) and (4, 1), and those of qwen2-vl-2b, hubert-xlarge,
gemma2-9b and gemma3-12b on (2, 2): 2 steps of 8 x 16 tokens (or
positions: qwen2-vl's patches, tokens and M-RoPE positions, hubert's
frames, as ``tests/test_torch_frontends.py`` builds them), 2
microbatches.
Against the one-process step on the same weights: the gathered params
(rtol 1e-5, atol 1e-6), losses and grad norms (rtol 1e-5); only the
order of the sum over the data ranks differs. The first loss is held
against JAX's ``make_train_step`` (rtol 1e-5). Each rank stores only
its blocks. llama3-8b also trains on (2, 2) in its own bfloat16
compute, against the one-process bf16 step within tolerances set from
measured readings. Then the elastic case of
``tests/test_distributed.py``: a sharded save on (2, 2),
``remesh_plan`` after losing half the ranks, a restore onto the (1, 2)
mesh of the two survivors (the saved params back bit for bit) and one
step there. A sharded save whose write fails raises on every rank.
``chip_smoke.py`` phase 14 is rehearsed on one in-process gloo rank.
MoE models on the mesh: ``tests/test_torch_fsdp_moe.py``.
"""
import builtins
import dataclasses
import json
import os
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_frontends import frontend_batch
from test_torch_spmd import _start, _wait, free_port

from repro.configs import get_smoke_config as jax_smoke
from repro.models import model as jax_model
from repro.models import steps as jax_steps
from repro.optim import adamw_init as jax_adamw_init
from repro_torch import sharding
from repro_torch.checkpoint.manager import _flatten
from repro_torch.configs import get_smoke_config
from repro_torch.launch import fsdp
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import convert, model, steps
from repro_torch.optim import adamw_init

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
ARCHS = ("llama3-8b", "mamba2-370m")
MESHES = ((2, 2), (4, 1))
# on (2, 2), the archs whose inputs and layers the two above do not
# reach: M-RoPE positions split on axis 1 and the gathered frontend_proj
# (qwen2-vl); frames, no causal mask and a token table nothing reads, so
# that it gets no gradient (hubert); softcaps, windows of 8 that cut the
# 16 positions, post-norms, embed_scale and a tied embedding read for
# the input and again for the logits (gemma2, gemma3)
MORE_ARCHS = ("qwen2-vl-2b", "hubert-xlarge", "gemma2-9b", "gemma3-12b")
CASES = [pytest.param(a, s, id=f"{a}-shape{MESHES.index(s)}")
         for a, s in [(a, s) for a in ARCHS for s in MESHES]
         + [(a, (2, 2)) for a in MORE_ARCHS]]
ALL_ARCHS = ARCHS + MORE_ARCHS
STEPS, BATCH, SEQ, MICRO = 2, 8, 16, 2
KW = dict(num_microbatches=MICRO, peak_lr=1e-3, warmup_steps=1,
          total_steps=10)
RTOL, ATOL = 1e-5, 1e-6
# bfloat16 compute, the configs' own: each rank's weight gradient leaves
# the bf16 matmul rounded to bf16 as a partial sum over its rows, where
# the one-process step rounds the whole batch's sum once. Measured on
# the CPU against the one-process step: losses within 8.8e-8 and grad
# norms within 3.8e-6 relative; the first batch's gradients within
# 5.4e-3 of each leaf's largest |value| (two bf16 ulps). The bounds are
# about four to five times those readings. Params after AdamW are not
# compared: its first update is lr * sign(g), which a rounding flips
# where g is near 0.
BF16 = (("llama3-8b", (2, 2)),)
BF16_RTOL, BF16_GRAD_TOL = 2e-5, 2e-2

RANK_SCRIPT = r'''
import os, pickle, dataclasses
from datetime import timedelta
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from repro_torch.checkpoint import CheckpointManager, restore, save
from repro_torch.configs import get_smoke_config
from repro_torch.launch import fsdp
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import convert, model, steps
from repro_torch.optim import adamw_init
from repro_torch.runtime import ElasticState, remesh_plan
from repro_torch.runtime.elastic import build_mesh_from_plan

rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
out = os.environ["FSDP_OUT"]
torch.set_num_threads(1)       # four ranks share the worker's cores
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + os.environ["FSDP_PORT"],
                        rank=rank, world_size=world, timeout=timedelta(seconds=90))
with open(os.path.join(out, "job.pkl"), "rb") as f:
    job = pickle.load(f)
N = lambda t: t.detach().numpy().copy()
res = {"runs": {}, "bf16": {}}
batches = {arch: [{k: torch.from_numpy(v) for k, v in b.items()} for b in bs]
           for arch, bs in job["batches"].items()}


def train_on(cfg, arch, shape):
    """Every step on the mesh from the job's weights: (run, layout,
    params blocks, params gathered)."""
    full = convert.params_from_numpy(cfg, job["weights"][arch], "cpu")
    mesh = mesh_lib.make_mesh(shape, "cpu")
    layout = fsdp.Layout(cfg, mesh)
    params = layout.shard(full)
    opt = adamw_init(params)
    step = steps.make_train_step(cfg, layout=layout, **job["kw"])
    run = {"losses": [], "norms": [], "coords": layout.coords,
           "stored": {"params": fsdp.numel(params), "m": fsdp.numel(opt["m"]),
                      "v": fsdp.numel(opt["v"])}}
    for b in batches[arch]:
        params, opt, m = step(params, opt, b)
        run["losses"].append(float(m["loss"]))
        run["norms"].append(float(m["grad_norm"]))
    whole = layout.full(params)
    if rank == 0:
        run["params"] = model.tree_map(N, whole)
    return run, layout, params, whole


for arch, shape in job["cases"]:
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    run, layout, params, whole = train_on(cfg, arch, shape)
    mesh = layout.mesh
    if (arch, shape) == job["cases"][0]:
        # the blocks are DTensor's under mesh.placements; init keeps them
        drawn = fsdp.init_params(cfg, layout, 0, "cpu")
        ref = model.init_params(cfg, 0, "cpu")
        run["init_equal"] = all(torch.equal(a, layout.block(b, s)) for (a, s), b in zip(
            mesh_lib.zip_specs(drawn, layout.specs), model._leaves(ref)))
        run["dtensor_equal"] = all(
            torch.equal(DTensor.from_local(t, mesh, mesh_lib.placements(s, mesh)).full_tensor(), w)
            for (t, s), w in zip(mesh_lib.zip_specs(params, layout.specs),
                                 model._leaves(whole)))
    res["runs"][arch, shape] = run
# the compute dtype the configs train in: bf16 gathers, f32 gradient sums
for arch, shape in job["bf16"]:
    cfg = get_smoke_config(arch)
    run, layout, _, _ = train_on(cfg, arch, shape)
    full = convert.params_from_numpy(cfg, job["weights"][arch], "cpu")
    _, _, grads = steps.value_and_grad(cfg, layout.shard(full), batches[arch][0],
                                       layout=layout)
    grads = layout.full(grads)
    if rank == 0:
        run["grads"] = model.tree_map(N, grads)
    res["bf16"][arch, shape] = run

# elastic: save on (2, 2), lose ranks 2 and 3, restore on (1, 2)
cfg = get_smoke_config("qwen3-1.7b")
mesh = mesh_lib.make_mesh((2, 2), "cpu")
layout = fsdp.Layout(cfg, mesh)
params = fsdp.init_params(cfg, layout, 0, "cpu")
opt = adamw_init(params)
step = steps.make_train_step(cfg, layout=layout)
params, opt, m = step(params, opt, batches["llama3-8b"][0])
res["elastic_loss_before"] = float(m["loss"])
shardings = mesh_lib.named(mesh, {"params": layout.specs,
                                  "opt": mesh_lib.opt_specs(layout.specs)})
# a write that fails on the writer (the path is a file) raises on every rank
try:
    save(job["bad_ckpt"], 1, params, shardings=shardings["params"])
    res["bad_save"] = "no error"
except (OSError, RuntimeError) as e:
    res["bad_save"] = type(e).__name__
mgr = CheckpointManager(job["bad_ckpt"])
mgr.save_async(1, params, shardings=shardings["params"])
try:
    mgr.wait()
    res["bad_save_async"] = "no error"
except (OSError, RuntimeError) as e:
    res["bad_save_async"] = type(e).__name__
save(job["ckpt"], 1, {"params": params, "opt": opt}, shardings=shardings)
whole = layout.full(params)
if rank == 0:
    res["saved_params"] = model.tree_map(N, whole)
plan = remesh_plan(ElasticState(num_hosts=4, devices_per_host=1, model_axis=2, data_axis=2),
                   surviving_hosts=[0, 1], global_batch=BATCH, microbatches=1)
res["plan"] = plan
mesh2 = build_mesh_from_plan(plan, "cpu")
res["coords2"] = mesh2.get_coordinate()
if mesh2.get_coordinate() is not None:
    layout2 = fsdp.Layout(cfg, mesh2)
    like = layout2.shard(model.abstract_params(cfg))
    state = restore(job["ckpt"], 1, {"params": like, "opt": adamw_init(like)}, "cpu",
                    mesh_lib.named(mesh2, {"params": layout2.specs,
                                           "opt": mesh_lib.opt_specs(layout2.specs)}))
    res["restored_numel"] = fsdp.numel(state["params"])
    restored = layout2.full(state["params"])
    if rank == 0:
        res["restored_params"] = model.tree_map(N, restored)
    step2 = steps.make_train_step(cfg, num_microbatches=plan["microbatches"], layout=layout2)
    _, _, m2 = step2(state["params"], state["opt"], batches["llama3-8b"][0])
    res["elastic_loss_after"] = float(m2["loss"])
with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(res, f)
dist.destroy_process_group()
'''.replace("BATCH", str(BATCH))


def lm_batch(vocab, seed):
    toks = np.random.default_rng(seed).integers(1, vocab, (BATCH, SEQ + 1)) \
        .astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def train_batches(arch, vocab):
    """The global batches of every step, the same on every rank: tokens,
    or the front end's inputs with labels."""
    if get_smoke_config(arch).frontend == "tokens":
        return [lm_batch(vocab, 10 + i) for i in range(STEPS)]
    return [frontend_batch(arch, b=BATCH, s=SEQ, seed=10 + i, labels=True)
            for i in range(STEPS)]


def configs(arch):
    """(JAX config, port config) of one smoke arch in float32 compute."""
    over = {"compute_dtype": "float32"}
    return (dataclasses.replace(jax_smoke(arch), **over),
            dataclasses.replace(get_smoke_config(arch), **over))


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """(each rank's results, the JAX weights and batches, the checkpoint
    directory): the 4-rank gloo group runs while this process waits."""
    out = tmp_path_factory.mktemp("fsdp")
    weights, batches = {}, {}
    for arch in ALL_ARCHS:
        jcfg, _ = configs(arch)
        jp = jax_model.init_params(jcfg, jax.random.key(0))
        weights[arch] = jax.tree.map(np.asarray, jp)
        batches[arch] = train_batches(arch, jcfg.vocab_size)
    job = {"cases": [tuple(c.values) for c in CASES], "bf16": BF16,
           "weights": weights,
           "batches": batches, "kw": KW, "ckpt": str(out / "ckpt"),
           "bad_ckpt": str(out / "not_a_directory")}
    (out / "not_a_directory").write_text("")
    with open(out / "job.pkl", "wb") as f:
        pickle.dump(job, f)
    port = str(free_port())
    logs = [out / f"rank{r}.log" for r in range(WORLD)]
    procs = [_start([RANK_SCRIPT], logs[r], RANK=str(r),
                    WORLD_SIZE=str(WORLD), FSDP_PORT=port, FSDP_OUT=str(out))
             for r in range(WORLD)]
    _wait(procs, logs, "the 4-rank FSDP group")
    ranks = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, job


def one_process_steps(cfg, weights, batches):
    """The port's one-process steps: (losses, grad norms, params)."""
    params = convert.params_from_numpy(cfg, weights, "cpu")
    opt = adamw_init(params)
    step = steps.make_train_step(cfg, **KW)
    losses, norms = [], []
    for b in batches:
        params, opt, m = step(params, opt,
                              {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, params


@pytest.fixture(scope="module")
def one_process(group):
    """The one-process steps on the same weights and batches, in float32
    compute: {arch: (losses, grad norms, params)}."""
    _, job = group
    return {arch: one_process_steps(configs(arch)[1], job["weights"][arch],
                                    job["batches"][arch])
            for arch in ALL_ARCHS}


def _numpy(tree):
    return [np.asarray(t) for t in model._leaves(tree)]


@pytest.mark.parametrize("arch,shape", CASES)
def test_fsdp_step_matches_one_process(group, one_process, arch, shape):
    ranks, _ = group
    losses, norms, params = one_process[arch]
    for r in ranks:
        run = r["runs"][arch, shape]
        np.testing.assert_allclose(run["losses"], losses, rtol=RTOL)
        np.testing.assert_allclose(run["norms"], norms, rtol=RTOL)
    got = ranks[0]["runs"][arch, shape]["params"]
    for a, b in zip(_numpy(got), [t.numpy() for t in model._leaves(params)]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch,shape", BF16)
def test_fsdp_bf16_step_matches_one_process(group, arch, shape):
    """In the configs' own bfloat16 compute, over real collectives: the
    bf16 blocks gathered, the gradients summed over the data ranks in
    float32. Against the one-process bf16 step, within bounds set from
    measured readings (``BF16``): the losses and grad norms of both
    steps, and the first batch's gradients leaf by leaf."""
    ranks, job = group
    cfg = get_smoke_config(arch)
    losses, norms, _ = one_process_steps(cfg, job["weights"][arch],
                                         job["batches"][arch])
    for r in ranks:
        run = r["bf16"][arch, shape]
        assert run["losses"] == ranks[0]["bf16"][arch, shape]["losses"]
        np.testing.assert_allclose(run["losses"], losses, rtol=BF16_RTOL)
        np.testing.assert_allclose(run["norms"], norms, rtol=BF16_RTOL)
    params = convert.params_from_numpy(cfg, job["weights"][arch], "cpu")
    _, _, grads = steps.value_and_grad(
        cfg, params, {k: torch.from_numpy(v)
                      for k, v in job["batches"][arch][0].items()})
    got = ranks[0]["bf16"][arch, shape]["grads"]
    for a, b in zip(_numpy(got), [t.numpy() for t in model._leaves(grads)]):
        assert np.abs(a - b).max() <= BF16_GRAD_TOL * np.abs(b).max()


@pytest.mark.parametrize("arch,shape", CASES)
def test_each_rank_stores_its_blocks(group, arch, shape):
    """Params, m and v: each rank's numel is its blocks' under the
    specs, and the ranks' coordinates cover the mesh once."""
    ranks, _ = group
    _, cfg = configs(arch)
    mesh = mesh_lib.MeshShape(shape, ("data", "model"))
    tree = model.abstract_params(cfg)
    specs = mesh_lib.param_specs(cfg, mesh, tree)
    want = sum(int(np.prod(sharding.block_shape(t.shape, s, mesh)))
               for t, s in mesh_lib.zip_specs(tree, specs))
    full = sum(t.numel() for t in model._leaves(tree))
    assert want < full
    coords = set()
    for r in ranks:
        run = r["runs"][arch, shape]
        assert run["stored"] == {"params": want, "m": want, "v": want}
        coords.add(tuple(run["coords"]))
    assert coords == {(i, j) for i in range(shape[0])
                      for j in range(shape[1])}


def test_blocks_are_dtensor_placements_and_init_keeps_them(group):
    """On (2, 2): ``DTensor.from_local(block, mesh, placements(spec))``
    gathers each leaf back whole, and ``fsdp.init_params`` draws the
    same blocks as ``model.init_params``' whole tree."""
    ranks, _ = group
    for r in ranks:
        run = r["runs"][tuple(CASES[0].values)]
        assert run["dtensor_equal"] and run["init_equal"]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_first_fsdp_loss_matches_jax(group, arch):
    ranks, job = group
    jcfg, _ = configs(arch)
    jp = jax.tree.map(jnp.asarray, job["weights"][arch])
    jstep = jax.jit(jax_steps.make_train_step(jcfg, **KW))
    _, _, m = jstep(jp, jax_adamw_init(jp),
                    jax.tree.map(jnp.asarray, job["batches"][arch][0]))
    for shape in {s for a, s in ranks[0]["runs"] if a == arch}:
        np.testing.assert_allclose(ranks[0]["runs"][arch, shape]["losses"][0],
                                   float(m["loss"]), rtol=RTOL)


def test_elastic_save_remesh_restore(group):
    """Saved on (2, 2), restored onto the (1, 2) mesh of ranks 0 and 1:
    the file holds the gathered params, the survivors gather them back
    bit for bit, and a step there gives a finite loss."""
    ranks, job = group
    plan = ranks[0]["plan"]
    assert plan["mesh_shape"] == (1, 2) and plan["devices_used"] == 2
    assert [r["coords2"] and tuple(r["coords2"]) for r in ranks] == [
        (0, 0), (0, 1), None, None]
    saved = ranks[0]["saved_params"]
    step_dir = os.path.join(job["ckpt"], "step_00000001")
    with open(os.path.join(step_dir, "metadata.json")) as f:
        paths = json.load(f)["paths"]
    with np.load(os.path.join(step_dir, "arrays.npz")) as z:
        stored = {p: z[f"leaf_{i}"] for i, p in enumerate(paths)}
    for path, want in _flatten({"params": saved}):
        np.testing.assert_array_equal(stored[path], want)
    restored = ranks[0]["restored_params"]
    for a, b in zip(_numpy(restored), _numpy(saved)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert ranks[0]["restored_numel"] < sum(a.size for a in _numpy(saved))
    for r in ranks[:2]:
        assert np.isfinite(r["elastic_loss_after"])
    assert all("elastic_loss_after" not in r for r in ranks[2:])


def test_failed_sharded_save_raises_on_every_rank(group):
    """The writer's own error on the writer; on the other three ranks a
    ``RuntimeError``, in ``save`` and at ``save_async``'s ``wait``, so no
    rank goes on as if the checkpoint were committed."""
    ranks, _ = group
    for key in ("bad_save", "bad_save_async"):
        assert issubclass(getattr(builtins, ranks[0][key]), OSError), key
        assert [r[key] for r in ranks[1:]] == ["RuntimeError"] * 3, key


# ---------------------------------------------------------------------------
# one process: no fallback, and chip_smoke.py phase 14 rehearsed
# ---------------------------------------------------------------------------

def test_meshes_and_train_need_a_group_of_the_device_backend():
    """No group is started silently: the mesh builders and ``train(mesh=)``
    raise without one, and a gloo group is refused for CUDA."""
    from repro_torch.launch.train import train
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh_lib.make_host_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh_lib.make_mesh((1, 1), "cpu")
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = mesh_lib.make_host_mesh(device="cpu")
        assert tuple(mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("data", "model")
        with pytest.raises(RuntimeError, match="needs 'nccl'"):
            mesh_lib.require_group("cuda", "make_host_mesh")
    finally:
        dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="init_process_group"):
        train("qwen3-1.7b", steps=1, batch=2, seq=8, device="cpu", mesh=mesh)


def test_chip_smoke_fsdp_path_rehearsal_on_cpu():
    """chip_smoke.py's phase 14 at the smoke size of qwen3-1.7b on one
    in-process gloo rank: two sharded training steps, the float32
    routes bit for bit, the sharded save and restore, 14e's two steps of
    granite-moe-1b-a400m and its float32 routes (``moe_aux`` too) bit
    for bit, and the pod-mesh dry run of three cells; the group is
    destroyed afterwards."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    out = chip_smoke.fsdp_path(
        torch.device("cpu"), "gloo", smoke=True, steps=2, batch=2, seq=16,
        route_batch=2, cells=[("qwen3-1.7b", "train_4k"),
                              ("gemma3-12b", "long_500k"),
                              ("mamba2-370m", "decode_32k")])
    assert not dist.is_initialized()
    assert len(out["train"]["losses"]) == 2
    routes = out["routes"]
    assert routes["loss_equal"] and routes["norm_equal"]
    assert routes["unequal_leaves"] == [] and routes["leaves"] > 10
    assert out["save"]["unequal_leaves"] == 0 and out["save"]["step"] == 2
    moe = out["moe"]
    assert len(moe["train"]["losses"]) == 2
    assert moe["train"]["arch"] == "granite-moe-1b-a400m"
    routes = moe["routes"]
    assert routes["holds"] == "bit for bit" and routes["aux_equal"]
    assert routes["moe_aux"]["one"] > 0 and routes["leaves"] > 10
    assert [r["mesh"] for r in out["dryrun"]] == ["16x16", "2x16x16"] * 3
    assert all(r["memory"]["peak"] == "not estimated" for r in out["dryrun"])
