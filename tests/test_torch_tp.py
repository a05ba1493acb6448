"""Tensor-parallel attention and dense MLP over ``model``
(``repro_torch/launch/fsdp.py``'s ``Layout(..., tensor_parallel=True)``,
``ModelSplit``; ``models/model.py``'s ``attn_share``,
``models/layers.py``'s ``mlp_share``) on four gloo ranks, spawned once
as ``tests/test_torch_fsdp.py`` spawns them.

Each case trains an arch's smoke config 2 steps of 8 x 16 tokens, 2
microbatches, from the JAX package's initial weights, with the layers
split where ``split_sublayers`` allows; ``HEADS`` replaces the heads to
8 query and 4 KV heads, so that m = 4 divides them. Against the
one-process step on the same weights: the losses and grad norms at
``tests/test_torch_fsdp.py``'s ``RTOL``, the first batch's gradients
leaf by leaf within ``GRAD_TOL`` and, for the float32 (1, 4) cases, the
params after AdamW at its ``RTOL``/``ATOL`` and the first loss against
JAX's ``make_train_step`` on the same replaced config. The bfloat16
case holds its gradients to ``BF16_GRAD_TOL`` and its losses and norms
to ``TP_BF16_RTOL`` (below). Each rank's gathered split leaves are 1/m
of the whole (the columns of wq/wk/wv/wi_gate/wi_up, the rows of wo), a
layer whose heads m does not divide runs its attention whole, and
``Layout.split`` records which sublayers split. On one in-process rank
(m = 1) nothing splits and the step is the one-process step bit for
bit.
"""
import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_fsdp import ATOL, BF16_GRAD_TOL, KW, RTOL, STEPS, lm_batch
from test_torch_spmd import _start, _wait, free_port

from repro.configs import get_smoke_config as jax_smoke
from repro.models import model as jax_model
from repro.models import steps as jax_steps
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.configs import get_smoke_config
from repro_torch.launch import fsdp
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import convert, model, steps
from repro_torch.optim import adamw_init

WORLD = 4
HEADS = {"num_heads": 8, "num_kv_heads": 4}
#: (arch, mesh, compute dtype, heads replaced): the (1, 4) cases split
#: every attention and dense MLP of llama3 and gemma3 (windows of 8 over
#: 16 positions, post-norms, qk_norm) four ways; llama3 with its own 4/2 heads
#: splits only its MLPs (Hkv = 2); on (2, 2) the split meets the data
#: split, and each layer is checkpointed under remat "dots" (``REMAT``),
#: so that the backward gathers it and all-reduces its outputs again
CASES = (("llama3-8b", (1, 4), "float32", True),
         ("gemma3-12b", (1, 4), "float32", True),
         ("llama3-8b", (1, 4), "bfloat16", True),
         ("llama3-8b", (1, 4), "float32", False),
         ("llama3-8b", (2, 2), "float32", False))
REMAT = {CASES[4]: {"remat": True, "remat_policy": "dots"}}
IDS = [f"{a}-{'x'.join(map(str, s))}-{d}{'-8h' if h else ''}"
       for a, s, d, h in CASES]
F32_PARAMS = tuple(c for c in CASES if c[1] == (1, 4) and c[2] == "float32")
# of each leaf's largest |g|: a split moves the forward's sums, and so
# every gradient, by float32 roundings (measured below 1.5e-6 on these
# cases; 2.8e-5 on jamba's smallest Mamba-2 leaf, whose largest |g| is
# 2.8e-5, split on (2, 2))
GRAD_TOL = 1e-4
# bfloat16: a split re-associates each split product's float32 sum, and
# where that sum lands on the other side of a bf16 rounding boundary
# (about 3e-5 of the elements of a product, measured on the CPU) what
# follows it rounds its own way. The one-process step's losses and norms
# then differ from the split one's by more than BF16_RTOL, which was set
# for the data split, where the forward stays bit for bit: measured
# 4.0e-5 (losses) and 6.0e-5 (norms) on this case, 1.06e-4 (norms) for
# llama3 on (2, 2). The first batch's gradients were equal bit for bit
# here and hold to BF16_GRAD_TOL.
TP_BF16_RTOL = 2e-4

RANK_SCRIPT = r'''
import os, pickle, dataclasses
from datetime import timedelta
import torch
import torch.distributed as dist
from repro_torch.configs import get_smoke_config
from repro_torch.launch import fsdp
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import convert, model, steps
from repro_torch.optim import adamw_init

rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
out = os.environ["TP_OUT"]
torch.set_num_threads(1)       # four ranks share the worker's cores
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + os.environ["TP_PORT"],
                        rank=rank, world_size=world, timeout=timedelta(seconds=90))
with open(os.path.join(out, "job.pkl"), "rb") as f:
    job = pickle.load(f)
N = lambda t: t.detach().numpy().copy()
batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in job["batches"]]
meshes = {}
res = {}
for case in job["cases"]:
    arch, shape, dtype, heads = case
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype=dtype,
                              **(job["heads"] if heads else {}),
                              **job["remat"].get(case, {}))
    full = convert.params_from_numpy(cfg, job["weights"][arch, heads], "cpu")
    if shape not in meshes:
        meshes[shape] = mesh_lib.make_mesh(shape, "cpu")
    layout = fsdp.Layout(cfg, meshes[shape], tensor_parallel=True)
    run = {"split": layout.split, "losses": [], "norms": []}
    with torch.no_grad():
        run["gathered"] = [
            {f"{n}/{k}": tuple(v.shape) for n in fsdp.SPLIT_LEAVES if n in g
             for k, v in g[n].items() if k in fsdp.SPLIT_LEAVES[n]}
            for g in (layout.gather_layer(i, p) for i, p in
                      enumerate(layout.shard(full)["layers"]))]
    _, _, grads = steps.value_and_grad(cfg, layout.shard(full), batches[0],
                                       layout=layout)
    grads = layout.full(grads)
    params = layout.shard(full)
    opt = adamw_init(params)
    step = steps.make_train_step(cfg, layout=layout, **job["kw"])
    for b in batches:
        params, opt, m = step(params, opt, b)
        run["losses"].append(float(m["loss"]))
        run["norms"].append(float(m["grad_norm"]))
    whole = layout.full(params)
    if rank == 0:
        run["grads"] = model.tree_map(N, grads)
        run["params"] = model.tree_map(N, whole)
    res[case] = run
with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(res, f)
dist.destroy_process_group()
'''


def configs(case):
    """(JAX config, port config) of one case."""
    arch, _, dtype, heads = case
    over = {"compute_dtype": dtype, **(HEADS if heads else {}),
            **REMAT.get(case, {})}
    return (dataclasses.replace(jax_smoke(arch), **over),
            dataclasses.replace(get_smoke_config(arch), **over))


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """(each rank's results, the job): the 4-rank gloo group runs while
    this process waits."""
    out = tmp_path_factory.mktemp("tp")
    weights = {}
    for arch, shape, _, heads in CASES:
        if (arch, heads) not in weights:
            jcfg, _ = configs((arch, shape, "float32", heads))
            weights[arch, heads] = jax.tree.map(
                np.asarray, jax_model.init_params(jcfg, jax.random.key(0)))
    vocab, = {jax_smoke(a).vocab_size for a, *_ in CASES}
    job = {"cases": CASES, "heads": HEADS, "remat": REMAT,
           "weights": weights, "kw": KW,
           "batches": [lm_batch(vocab, 10 + i) for i in range(STEPS)]}
    with open(out / "job.pkl", "wb") as f:
        pickle.dump(job, f)
    port = str(free_port())
    logs = [out / f"rank{r}.log" for r in range(WORLD)]
    procs = [_start([RANK_SCRIPT], logs[r], RANK=str(r),
                    WORLD_SIZE=str(WORLD), TP_PORT=port, TP_OUT=str(out))
             for r in range(WORLD)]
    _wait(procs, logs, "the 4-rank tensor-parallel group")
    ranks = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, job


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def one_process(group):
    """{case: (losses, grad norms, params after the steps, the first
    batch's gradients)} of the one-process step on the same weights."""
    _, job = group
    out = {}
    for case in CASES:
        arch, _, _, heads = case
        _, cfg = configs(case)
        params = convert.params_from_numpy(cfg, job["weights"][arch, heads],
                                           "cpu")
        _, _, grads = steps.value_and_grad(cfg, params,
                                           _torch_batch(job["batches"][0]))
        opt = adamw_init(params)
        step = steps.make_train_step(cfg, **KW)
        losses, norms = [], []
        for b in job["batches"]:
            params, opt, m = step(params, opt, _torch_batch(b))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[case] = (losses, norms, params, grads)
    return out


def _leaves(tree):
    return [np.asarray(t) for t in model._leaves(tree)]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_step_matches_one_process(group, one_process, case):
    ranks, _ = group
    losses, norms, params, grads = one_process[case]
    rtol = TP_BF16_RTOL if case[2] == "bfloat16" else RTOL
    for r in ranks:
        run = r[case]
        assert run["losses"] == ranks[0][case]["losses"]
        np.testing.assert_allclose(run["losses"], losses, rtol=rtol)
        np.testing.assert_allclose(run["norms"], norms, rtol=rtol)
    tol = BF16_GRAD_TOL if case[2] == "bfloat16" else GRAD_TOL
    got = ranks[0][case]
    for a, b in zip(_leaves(got["grads"]), _leaves(grads)):
        assert np.abs(a - b).max() <= tol * np.abs(b).max()
    if case in F32_PARAMS:
        for a, b in zip(_leaves(got["params"]), _leaves(params)):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", [c for c in F32_PARAMS if c[3]],
                         ids=lambda c: c[0])
def test_first_split_loss_matches_jax(group, case):
    ranks, job = group
    arch, _, _, heads = case
    jcfg, _ = configs(case)
    jp = jax.tree.map(jnp.asarray, job["weights"][arch, heads])
    jstep = jax.jit(jax_steps.make_train_step(jcfg, **KW))
    _, _, m = jstep(jp, jax_adamw_init(jp),
                    jax.tree.map(jnp.asarray, job["batches"][0]))
    np.testing.assert_allclose(ranks[0][case]["losses"][0], float(m["loss"]),
                               rtol=RTOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_layers_compute_their_block(group, case):
    """Where a layer splits, each rank's gathered wq/wk/wv/wi_gate/wi_up
    hold 1/m of the columns and its wo 1/m of the rows: the compute is
    split, not only the storage. What the layout records split is what
    divides by m: attention where H and Hkv do, the dense MLP where d_ff
    does; Mamba-2 mixers and MoE layers never."""
    ranks, _ = group
    arch, shape, _, _ = case
    _, cfg = configs(case)
    m = shape[1]
    d, hd = cfg.d_model, cfg.head_dim
    for r in ranks:
        run = r[case]
        for i, (split, got) in enumerate(zip(run["split"], run["gathered"])):
            spec = cfg.layer_spec(i)
            want_split = []
            if spec.mixer.startswith("attn") and cfg.num_heads % m == 0 \
                    and cfg.num_kv_heads % m == 0:
                want_split.append("attn")
            if spec.mlp == "dense":
                want_split.append("mlp")        # d_ff 128 divides by 2, 4
            assert split == tuple(want_split), (i, split)
            full = {"attn/wq": (d, cfg.num_heads * hd),
                    "attn/wk": (d, cfg.num_kv_heads * hd),
                    "attn/wv": (d, cfg.num_kv_heads * hd),
                    "attn/wo": (cfg.num_heads * hd, d),
                    "mlp/wi_gate": (d, cfg.d_ff), "mlp/wi_up": (d, cfg.d_ff),
                    "mlp/wo": (cfg.d_ff, d)}
            want = {}
            for k, (rows, cols) in full.items():
                if k not in got:
                    continue
                if k.split("/")[0] in split:
                    rows, cols = ((rows // m, cols) if k.endswith("wo")
                                  else (rows, cols // m))
                want[k] = (rows, cols)
            assert got == want, (i, got, want)
    if case == ("llama3-8b", (1, 4), "float32", False):
        assert all(s == ("mlp",) for s in ranks[0][case]["split"])


@pytest.mark.parametrize("arch", ("jamba-v0.1-52b", "granite-moe-1b-a400m",
                                  "mamba2-370m", "hubert-xlarge"))
@pytest.mark.parametrize("shape", ((2, 2), (1, 4), (4, 1)))
def test_split_sublayers_of_every_layer_kind(arch, shape):
    """``split_sublayers`` on a mesh's specs: attention where H and Hkv
    divide by m, the dense MLP where d_ff does (jamba's dense layers
    beside its Mamba-2 mixers), never a Mamba-2 mixer or a MoE layer
    (granite), and nothing at m = 1."""
    cfg = get_smoke_config(arch)
    m = shape[1]
    specs = mesh_lib.param_specs(cfg, mesh_lib.MeshShape(
        shape, ("data", "model")))
    for i in range(cfg.num_layers):
        spec = cfg.layer_spec(i)
        want = []
        if m > 1 and spec.mixer.startswith("attn") \
                and cfg.num_heads % m == 0 and cfg.num_kv_heads % m == 0:
            want.append("attn")
        if m > 1 and spec.mlp == "dense":
            want.append("mlp")
        got = fsdp.split_sublayers(cfg, specs["layers"][i], m)
        assert got == tuple(want), (i, spec, got)
    if arch == "jamba-v0.1-52b" and m == 2:
        assert {fsdp.split_sublayers(cfg, s, m) for s in specs["layers"]} \
            == {(), ("mlp",), ("attn", "mlp")}


def test_one_model_rank_is_the_one_process_step():
    """m = 1 (a (1, 1) mesh of one in-process gloo rank): the layout
    splits nothing, and two steps give the one-process step's losses,
    norms and params bit for bit."""
    _, cfg = configs(("llama3-8b", (1, 1), "bfloat16", True))
    batches = [_torch_batch(lm_batch(cfg.vocab_size, 10 + i))
               for i in range(STEPS)]
    full = model.init_params(cfg, 0, "cpu")

    def run(layout):
        params = (model.tree_map(torch.clone, full) if layout is None
                  else layout.shard(full))
        opt = adamw_init(params)
        step = steps.make_train_step(cfg, layout=layout, **KW)
        seen = []
        for b in batches:
            params, opt, m = step(params, opt, b)
            seen.append((m["loss"], m["grad_norm"]))
        return seen, params

    want, want_params = run(None)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        layout = fsdp.Layout(cfg, mesh_lib.make_mesh((1, 1), "cpu"),
                             tensor_parallel=True)
        assert layout.split == [()] * cfg.num_layers
        got, got_params = run(layout)
    finally:
        dist.destroy_process_group()
    for (a, b), (c, e) in zip(got, want):
        assert torch.equal(a, c) and torch.equal(b, e)
    for a, b in zip(model._leaves(got_params), model._leaves(want_params)):
        assert torch.equal(a, b)
