"""Tensor-parallel attention, Mamba-2 mixers and dense MLP over
``model`` (``repro_torch/launch/fsdp.py``'s ``Layout(...,
tensor_parallel=True)``, ``ModelSplit``; ``models/model.py``'s
``attn_share`` and ``mamba_split``, ``models/ssm.py``'s
``mamba2_share_in``/``_out``, ``models/layers.py``'s ``mlp_share``) on
four gloo ranks, spawned once as ``tests/test_torch_fsdp.py`` spawns
them.

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
of the whole (the columns of wq/wk/wv/wi_gate/wi_up/wz/wx/wdt, the rows
of wo, the heads of dt_bias/a_log/D), a layer whose heads m does not
divide runs its attention whole, and ``Layout.split`` records which
sublayers split. jamba's cases split its Mamba-2 mixers (8 SSD heads of
16 at the smoke width), its attention, its dense MLPs, its experts and
the vocabulary over ``model`` at once; the mixer's gated RMSNorm sums
its statistic over the ranks forward and backward, which only ranks in
other processes can check (one process's stand-in lets autograd add the
partial gradients itself). ``wB``, ``wC``, ``conv_w``, ``conv_b`` and
``norm``, read whole by every rank, get partial gradients summed over
``model``, held leaf by leaf like the rest. jamba's float32 case trains its
layers 2-5, its bfloat16 case one period (``JAMBA_LAYERS``), and the
bfloat16 case routes as the one-process step routed (``REPLAY``, through
``chip_smoke.RouteReplay``). On one in-process rank
(m = 1) nothing splits and the step is the one-process step bit for
bit.

The vocabulary splits too (``Layout.vocab``, ``fsdp.VocabSplit``): the
smoke V of 128 divides by 2 and 4, so every case looks up its tokens in
each rank's V/m rows of ``embed`` and computes the loss on its V/m
logits (``lm_head``'s columns, or the tied ``embed``'s rows read again),
the max, the sum of exponentials and the gold logit combined over
``model``. Each rank gathers ``embed``/``lm_head`` as its V/m rows
(columns). One case (``ODD_VOCAB``, a V that m = 2 does not divide)
splits its layers and keeps both tables whole, as granite's 49155 stays.
"""
import contextlib
import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_fsdp import ATOL, BF16_GRAD_TOL, KW, RTOL, STEPS, lm_batch
from test_torch_spmd import REPO, _start, _wait, free_port

import chip_smoke

from repro.configs import get_smoke_config as jax_smoke
from repro.models import model as jax_model
from repro.models import steps as jax_steps
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import fsdp
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import convert, model, steps
from repro_torch.optim import adamw_init

WORLD = 4
#: the ranks import the port and ``chip_smoke`` (its ``RouteReplay``)
PATH = os.pathsep.join((os.path.join(REPO, "src"), REPO))
HEADS = {"num_heads": 8, "num_kv_heads": 4}
#: (arch, mesh, compute dtype, heads replaced): the (1, 4) cases split
#: every attention and dense MLP of llama3 and gemma3 (windows of 8 over
#: 16 positions, post-norms, qk_norm) four ways; llama3 with its own 4/2 heads
#: splits only its MLPs (Hkv = 2); on (2, 2) the split meets the data
#: split, and each layer is checkpointed under remat "dots"; the sixth
#: case splits llama3's 8/4-head layers over m = 2 with a vocabulary that
#: 2 does not divide, so that its tables stay whole (``OVER``); jamba on
#: (1, 4) splits its mixers, attention, dense MLPs, experts and
#: vocabulary four ways, in float32 and bfloat16, and mamba2-370m's
#: mixers meet the data split on (2, 2)
CASES = (("llama3-8b", (1, 4), "float32", True),
         ("gemma3-12b", (1, 4), "float32", True),
         ("llama3-8b", (1, 4), "bfloat16", True),
         ("llama3-8b", (1, 4), "float32", False),
         ("llama3-8b", (2, 2), "float32", False),
         ("llama3-8b", (2, 2), "float32", True),
         ("jamba-v0.1-52b", (1, 4), "float32", True),
         ("mamba2-370m", (2, 2), "float32", False),
         ("jamba-v0.1-52b", (1, 4), "bfloat16", True))
#: a vocabulary that neither 2 nor 4 divides: the tables stay whole
ODD_VOCAB = 129
#: the layers of jamba's period of 8 that a jamba case trains, as its
#: period: the float32 case its layers 2-5 (Mamba-2 mixers with a dense
#: MLP and with experts, attention with a dense MLP: every layer kind it
#: has), the bfloat16 case the whole period. Each layer's gathers and
#: gradient sums are gloo collectives, ~2 s a step at 8 layers on an
#: idle machine. At layers 2-5 the bfloat16 split's second-step grad
#: norm reads 3.21e-4 off the one-process step's, where each of the two
#: bf16 steps is 5-8e-4 off the float32 step's: bf16 roundings, which the
#: whole period's 1.85e-4 keeps under TP_BF16_RTOL (PERF.md, section 7)
JAMBA_LAYERS = {CASES[6]: slice(2, 6), CASES[8]: slice(0, 8)}
#: config fields a case replaces besides its heads
OVER = {CASES[4]: {"remat": True, "remat_policy": "dots"},
        CASES[5]: {"vocab_size": ODD_VOCAB}}
#: the cases each 4-rank group runs, so that each keeps well inside
#: ``GROUP_TIMEOUT_S`` on a loaded machine
GROUPS = (CASES[:6], CASES[6:8], CASES[8:])
#: bfloat16 cases that route: their ranks route as the one-process step
#: routed (its expert ids replayed, the gates their own probabilities),
#: since one bf16 rounding that a split re-associates the other way can
#: flip a decision, and one flipped token moves its experts' gradients
#: by more than BF16_GRAD_TOL (measured: 1 decision of 1024 at jamba's 16
#: smoke layers, its last layer's expert gradients 1.56e-1 off); the
#: float32 cases route on their own
REPLAY = (CASES[8],)
IDS = [f"{a}-{'x'.join(map(str, s))}-{d}{'-8h' if h else ''}"
       + (f"-v{ODD_VOCAB}" if "vocab_size" in OVER.get(c, {}) else "")
       for c in CASES for a, s, d, h in [c]]
F32_PARAMS = tuple(c for c in CASES if c[1] == (1, 4) and c[2] == "float32")
# of each leaf's largest |g|: a split moves the forward's sums, and so
# every gradient, by float32 roundings (measured below 1.5e-6 on these
# cases; 2.8e-5 on jamba's smallest Mamba-2 leaf, whose largest |g| is
# 2.8e-5, split on (2, 2)). With the vocabulary split as well: 1.32e-6,
# 5.74e-6 (gemma3), 8.5e-7 and 1.16e-6 on the float32 cases, in order,
# and 9.8e-7 on the ODD_VOCAB case (tables whole); their losses equal,
# grad norms within 3.8e-7 relative, the (1, 4) cases' AdamW params at
# most 3.1e-7 past RTOL's share (ATOL 1e-6). With the Mamba-2 mixers
# split: 5.94e-6 (jamba's layers 2-5, (1, 4); 1.23e-5 at one period)
# and 2.29e-6 (mamba2-370m, (2, 2)), the losses within 9.8e-8 and the
# norms within 4.2e-7 relative
GRAD_TOL = 1e-4
# bfloat16: a split re-associates each split product's float32 sum, and
# where that sum lands on the other side of a bf16 rounding boundary
# (about 3e-5 of the elements of a product, measured on the CPU) what
# follows it rounds its own way. The one-process step's losses and norms
# then differ from the split one's by more than BF16_RTOL, which was set
# for the data split, where the forward stays bit for bit: measured
# 4.0e-5 (losses) and 6.0e-5 (norms) on this case, 1.06e-4 (norms) for
# llama3 on (2, 2). The first batch's gradients were equal bit for bit
# here and hold to BF16_GRAD_TOL. With the vocabulary split as well:
# 3.99e-5 (losses), 6.01e-5 (norms), the gradients still equal. jamba's
# bfloat16 case, its mixers split as well and its routes replayed:
# losses within 9.7e-8, norms 1.85e-4 (7.9e-5 with its mixers computed
# whole), gradients 9.4e-3 of each leaf's largest |g|.
TP_BF16_RTOL = 2e-4

RANK_SCRIPT = r'''
import contextlib, os, pickle
from datetime import timedelta
import torch
import torch.distributed as dist
import chip_smoke
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
    shape, cfg = case[1], job["cfgs"][case]
    full = convert.params_from_numpy(cfg, job["weights"][case], "cpu")
    if shape not in meshes:
        meshes[shape] = mesh_lib.make_mesh(shape, "cpu")
    layout = fsdp.Layout(cfg, meshes[shape], tensor_parallel=True)
    ids = job["routes"].get(case)
    replay = (contextlib.nullcontext() if ids is None
              else chip_smoke.RouteReplay(ids))
    run = {"split": layout.split, "losses": [], "norms": []}
    with torch.no_grad():
        run["gathered"] = [
            {f"{n}/{k}": tuple(v.shape) for n in fsdp.SPLIT_LEAVES if n in g
             for k, v in g[n].items() if k in fsdp.SPLIT_LEAVES[n]}
            for g in (layout.gather_layer(i, p) for i, p in
                      enumerate(layout.shard(full)["layers"]))]
        top = layout.gather_top(layout.shard(full), ("embed", "lm_head"))
    run["top"] = {k: tuple(v.shape) for k, v in top.items()}
    run["vocab"] = None if layout.vocab is None else layout.vocab.ranges
    with replay:
        _, _, grads = steps.value_and_grad(cfg, layout.shard(full),
                                           batches[0], layout=layout)
        grads = layout.full(grads)
        params = layout.shard(full)
        opt = adamw_init(params)
        step = steps.make_train_step(cfg, layout=layout, **job["kw"])
        for b in batches:
            params, opt, m = step(params, opt, b)
            run["losses"].append(float(m["loss"]))
            run["norms"].append(float(m["grad_norm"]))
    whole = layout.full(params)
    assert ids is None or len(replay.own) == len(ids), \
        f"{case}: {len(ids) - len(replay.own)} routes not replayed"
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
            **OVER.get(case, {})}
    out = []
    for cfg in (jax_smoke(arch), get_smoke_config(arch)):
        if case in JAMBA_LAYERS:
            pattern = cfg.pattern[JAMBA_LAYERS[case]]
            cfg = dataclasses.replace(cfg, pattern=pattern,
                                      num_layers=len(pattern))
        out.append(dataclasses.replace(cfg, **over))
    return tuple(out)


@pytest.fixture(scope="module")
def job():
    """The cases' weights (the JAX package's initial ones, float32) and
    batches, as the ranks and this process read them."""
    weights, inits = {}, {}
    for case in CASES:
        jcfg = dataclasses.replace(configs(case)[0], compute_dtype="float32")
        key = case[0], case[3], jcfg.vocab_size, jcfg.num_layers
        if key not in inits:
            inits[key] = jax.tree.map(
                np.asarray, jax_model.init_params(jcfg, jax.random.key(0)))
        weights[case] = inits[key]
    vocab, = {jax_smoke(a).vocab_size for a, *_ in CASES}
    return {"cfgs": {c: configs(c)[1] for c in CASES}, "weights": weights,
            "kw": KW,
            "batches": [lm_batch(vocab, 10 + i) for i in range(STEPS)]}


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def one_process(job):
    """{case: (losses, grad norms, params after the steps, the first
    batch's gradients, the expert ids of every ``moe.route`` call of
    a ``REPLAY`` case, else None)} of the one-process step on the same
    weights."""
    out = {}
    for case in CASES:
        _, cfg = configs(case)
        log = chip_smoke.RouteLog()
        with log if case in REPLAY else contextlib.nullcontext():
            params = convert.params_from_numpy(cfg, job["weights"][case],
                                               "cpu")
            _, _, grads = steps.value_and_grad(
                cfg, params, _torch_batch(job["batches"][0]))
            opt = adamw_init(params)
            step = steps.make_train_step(cfg, **KW)
            losses, norms = [], []
            for b in job["batches"]:
                params, opt, m = step(params, opt, _torch_batch(b))
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
        ids = log.ids if case in REPLAY else None
        out[case] = (losses, norms, params, grads, ids)
    return out


@pytest.fixture(scope="module")
def group(job, one_process, tmp_path_factory):
    """(each rank's results, the job): each of ``GROUPS`` runs as a
    4-rank gloo group while this process waits; a ``REPLAY`` case routes
    as the one-process step routed."""
    routes = {c: one_process[c][4] for c in REPLAY}
    ranks = [{} for _ in range(WORLD)]
    for cases in GROUPS:
        out = tmp_path_factory.mktemp("tp")
        with open(out / "job.pkl", "wb") as f:
            pickle.dump({**job, "cases": cases, "routes": routes}, f)
        port = str(free_port())
        logs = [out / f"rank{r}.log" for r in range(WORLD)]
        procs = [_start([RANK_SCRIPT], logs[r], RANK=str(r),
                        WORLD_SIZE=str(WORLD), TP_PORT=port,
                        TP_OUT=str(out), PYTHONPATH=PATH)
                 for r in range(WORLD)]
        _wait(procs, logs, "the 4-rank tensor-parallel group")
        for r in range(WORLD):
            with open(out / f"rank{r}.pkl", "rb") as f:
                ranks[r].update(pickle.load(f))
    return ranks, job


def _leaves(tree):
    return [np.asarray(t) for t in model._leaves(tree)]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_step_matches_one_process(group, one_process, case):
    ranks, _ = group
    losses, norms, params, grads, _ = one_process[case]
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
    jcfg, _ = configs(case)
    jp = jax.tree.map(jnp.asarray, job["weights"][case])
    jstep = jax.jit(jax_steps.make_train_step(jcfg, **KW))
    _, _, m = jstep(jp, jax_adamw_init(jp),
                    jax.tree.map(jnp.asarray, job["batches"][0]))
    np.testing.assert_allclose(ranks[0][case]["losses"][0], float(m["loss"]),
                               rtol=RTOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_layers_compute_their_block(group, case):
    """Where a layer splits, each rank's gathered
    wq/wk/wv/wi_gate/wi_up/wz/wx/wdt hold 1/m of the columns, its wo 1/m
    of the rows and its dt_bias/a_log/D 1/m of the heads: the compute is
    split, not only the storage. What the layout records split is what
    divides by m: attention where H and Hkv do, the Mamba-2 mixer where
    its heads do, the dense MLP where d_ff does; MoE layers never (their
    experts split as experts). The vocabulary splits
    too: each rank's gathered ``embed`` holds its V/m rows and
    ``lm_head`` its V/m columns, block ``model`` coordinate of the V;
    where m does not divide V (``ODD_VOCAB``) both stay whole while the
    layers split."""
    ranks, _ = group
    arch, shape, _, _ = case
    _, cfg = configs(case)
    m = shape[1]
    d, hd = cfg.d_model, cfg.head_dim
    di = cfg.ssm_expand * d
    nh = di // cfg.ssm_head_dim
    v = cfg.vocab_size // m
    for rank, r in enumerate(ranks):
        run = r[case]
        if cfg.vocab_size % m:
            v = cfg.vocab_size
            assert run["vocab"] is None
        else:
            lo = rank % m * v             # the model axis is the minor one
            assert run["vocab"] == ((lo, lo + v),)
        want_top = {"embed": (v, d)}
        if not cfg.tie_embeddings:
            want_top["lm_head"] = (d, v)
        assert run["top"] == want_top, run["top"]
        for i, (split, got) in enumerate(zip(run["split"], run["gathered"])):
            spec = cfg.layer_spec(i)
            want_split = []
            if spec.mixer.startswith("attn") and cfg.num_heads % m == 0 \
                    and cfg.num_kv_heads % m == 0:
                want_split.append("attn")
            if spec.mixer == "mamba":
                want_split.append("mamba")      # 8 heads divide by 2, 4
            if spec.mlp == "dense":
                want_split.append("mlp")        # d_ff 128 divides by 2, 4
            assert split == tuple(want_split), (i, split)
            full = {"attn/wq": (d, cfg.num_heads * hd),
                    "attn/wk": (d, cfg.num_kv_heads * hd),
                    "attn/wv": (d, cfg.num_kv_heads * hd),
                    "attn/wo": (cfg.num_heads * hd, d),
                    "mamba/wz": (d, di), "mamba/wx": (d, di),
                    "mamba/wdt": (d, nh), "mamba/dt_bias": (nh,),
                    "mamba/a_log": (nh,), "mamba/D": (nh,),
                    "mamba/wo": (di, d),
                    "mlp/wi_gate": (d, cfg.d_ff), "mlp/wi_up": (d, cfg.d_ff),
                    "mlp/wo": (cfg.d_ff, d)}
            want = {}
            for k, shape in full.items():
                if k not in got:
                    continue
                if k.split("/")[0] in split:
                    at = 0 if k.endswith("wo") or len(shape) == 1 else 1
                    shape = tuple(n // m if j == at else n
                                  for j, n in enumerate(shape))
                want[k] = shape
            assert got == want, (i, got, want)
    if case == ("llama3-8b", (1, 4), "float32", False):
        assert all(s == ("mlp",) for s in ranks[0][case]["split"])


@pytest.mark.parametrize("arch", ("jamba-v0.1-52b", "granite-moe-1b-a400m",
                                  "mamba2-370m", "hubert-xlarge"))
@pytest.mark.parametrize("shape", ((2, 2), (1, 4), (4, 1)))
def test_split_sublayers_of_every_layer_kind(arch, shape):
    """``split_sublayers`` on a mesh's specs: attention where H and Hkv
    divide by m, the Mamba-2 mixer where its heads do (jamba's and
    mamba2-370m's: 8 at the smoke width, 128 and 32 at the published
    one, whose first layer splits it too), the dense MLP where d_ff does
    (jamba's dense layers beside its mixers), never a MoE layer
    (granite), and nothing at m = 1."""
    cfg = get_smoke_config(arch)
    m = shape[1]
    nheads = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    specs = mesh_lib.param_specs(cfg, mesh_lib.MeshShape(
        shape, ("data", "model")))
    for i in range(cfg.num_layers):
        spec = cfg.layer_spec(i)
        want = []
        if m > 1 and spec.mixer.startswith("attn") \
                and cfg.num_heads % m == 0 and cfg.num_kv_heads % m == 0:
            want.append("attn")
        if m > 1 and spec.mixer == "mamba" and nheads % m == 0:
            want.append("mamba")
        if m > 1 and spec.mlp == "dense":
            want.append("mlp")
        got = fsdp.split_sublayers(cfg, specs["layers"][i], m)
        assert got == tuple(want), (i, spec, got)
    if arch == "jamba-v0.1-52b" and m == 2:
        assert {fsdp.split_sublayers(cfg, s, m) for s in specs["layers"]} \
            == {("mamba",), ("mamba", "mlp"), ("attn", "mlp")}
    if arch in ("jamba-v0.1-52b", "mamba2-370m") and m > 1:
        full = get_config(arch)
        fspecs = mesh_lib.param_specs(full, mesh_lib.MeshShape(
            shape, ("data", "model")))
        assert "mamba" in fsdp.split_sublayers(full, fspecs["layers"][0], m)


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
