"""MoE on the LM mesh (``repro_torch/launch/fsdp.py``'s ``MoeExchange``
and expert-parallel gather, ``repro_torch/models/moe.py`` with an
``exchange``) on four gloo ranks, spawned as ``tests/test_torch_fsdp.py``
spawns them, all float32.

Layer level: one MoE layer with numpy-seeded router and experts (E = 4,
d 32, ff 64; top-2, and top-1 with a shared expert) over 4 x 64 tokens,
at capacity factors 1.25 and 0.5 (where capacity binds), on the
(data, model) meshes (4, 1), (2, 2) and (1, 4): each rank takes its
rows of the tokens (the batch ranks' blocks) and its E/m experts.
Against JAX's ``moe_apply`` on the whole (T, d): the output within
rtol 1e-5 / atol 1e-6, the aux loss (the ranks' shares summed) within
rtol 1e-6, and the gradients of ``sum(y * w) + aux`` with respect to
the tokens, the router, the experts and the shared expert, summed over
the batch ranks, within 1e-5 of each leaf's largest |value| (top-1's
router within ``TOP1_ROUTER_TOL``). The control: at 0.5 on (4, 1), each
rank routing its own tokens alone misses that output.

Model level: 2 steps of 8 x 16 tokens, 2 microbatches, of the smoke
configs of granite-moe-1b-a400m on (2, 2) and (4, 1), llama4-scout on
(2, 2) and jamba on (2, 2), from the JAX package's initial weights,
against the one-process step (rtol 1e-5, as the fsdp test holds it)
and their first loss against the one JAX's ``make_train_step`` reports
(``jax_first_loss``); on (2, 2) every MoE layer ran with E/2 experts.
"""
import dataclasses
import functools
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_spmd import _start, _wait, free_port

from repro.configs import get_smoke_config as jax_smoke
from repro.models import model as jax_model
from repro.models import moe as jax_moe
from repro.models import steps as jax_steps
from repro_torch.configs import get_smoke_config
from repro_torch.models import convert, model, steps
from repro_torch.optim import adamw_init

WORLD = 4
TOKENS, D, FF, E = 4 * 64, 32, 64, 4
LAYER_MESHES = ((4, 1), (2, 2), (1, 4))
#: name -> (top k, shared expert)
LAYERS = {"top2": (2, False), "top1_shared": (1, True)}
FACTORS = (1.25, 0.5)
Y_RTOL, Y_ATOL = 1e-5, 1e-6
AUX_RTOL = 1e-6
GRAD_TOL = 1e-5             # of each leaf's largest |g|
# top-1's gate is g / g, whose gradient is float32 cancellation noise
# that each framework rounds its own way: what is left of the router's
# gradient is the aux loss's (its largest |g| 9e-3 here). The port's
# one-process layer is 1.4e-4 of that from JAX on these inputs, the
# sharded runs 0.95e-4 to 1.15e-4 (measured on the CPU). A wrong aux
# share moves it by its own size.
TOP1_ROUTER_TOL = 1e-3
MODEL_RUNS = (("granite-moe-1b-a400m", (2, 2)),
              ("granite-moe-1b-a400m", (4, 1)),
              ("llama4-scout-17b-a16e", (2, 2)),
              ("jamba-v0.1-52b", (2, 2)))
ARCHS = tuple(dict.fromkeys(a for a, _ in MODEL_RUNS))
STEPS, BATCH, SEQ = 2, 8, 16
KW = dict(num_microbatches=2, peak_lr=1e-3, warmup_steps=1, total_steps=10)
RTOL, ATOL = 1e-5, 1e-6

RANK_SCRIPT = r'''
import os, pickle, dataclasses, time
from datetime import timedelta
import torch
import torch.distributed as dist
from repro_torch.configs import get_smoke_config
from repro_torch.launch import fsdp
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import convert, model, moe, steps
from repro_torch.optim import adamw_init

rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
out = os.environ["FSDP_OUT"]
torch.set_num_threads(1)       # four ranks share the worker's cores
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + os.environ["FSDP_PORT"],
                        rank=rank, world_size=world, timeout=timedelta(seconds=90))
with open(os.path.join(out, "job.pkl"), "rb") as f:
    job = pickle.load(f)
N = lambda t: t.detach().numpy().copy()
res = {"layer": {}, "alone": {}, "model": {}}
meshes = {s: mesh_lib.make_mesh(s, "cpu") for s in job["layer_meshes"]}


def layer_run(name, factor, shape, alone=False):
    """This rank's rows and experts of one MoE layer, forward and
    backward of sum(y * w) + aux."""
    top_k, _ = job["layers"][name]
    w = job["weights"][name]
    ex = fsdp.MoeExchange(meshes[shape])
    rows = len(job["x"]) // ex.ranks
    held = w["wi_gate"].shape[0] // shape[1]
    mine = slice(ex.index * rows, (ex.index + 1) * rows)
    experts = slice(ex.model_rank * held, (ex.model_rank + 1) * held)
    p = {"router": torch.tensor(w["router"])}
    for k in ("wi_gate", "wi_up", "wo"):
        p[k] = torch.tensor(w[k][experts])
    if "shared" in w:
        p["shared"] = {k: torch.tensor(v) for k, v in w["shared"].items()}
    p = model.tree_map(lambda t: t.requires_grad_(), p)
    x = torch.tensor(job["x"][mine]).requires_grad_()
    y, aux = moe.moe_apply(p, x, top_k=top_k, capacity_factor=factor,
                           exchange=None if alone else ex)
    ((y * torch.tensor(job["w"][mine])).sum() + aux).backward()
    return {"index": ex.index, "model_rank": ex.model_rank, "y": N(y),
            "aux": float(aux), "x": N(x.grad),
            "grads": model.tree_map(lambda t: N(t.grad), p)}


for name in job["layers"]:
    for factor in job["factors"]:
        for shape in job["layer_meshes"]:
            res["layer"][name, factor, shape] = layer_run(name, factor, shape)
        res["alone"][name, factor] = layer_run(name, factor, (4, 1), alone=True)

# the models' weights, which the test's process draws meanwhile
while not os.path.exists(os.path.join(out, "models.pkl")):
    time.sleep(0.05)
with open(os.path.join(out, "models.pkl"), "rb") as f:
    models = pickle.load(f)

# the experts each MoE layer of the step computes
held = []
apply = moe.moe_apply
def counted(params, x, **kw):
    held.append(params["wi_gate"].shape[0])
    return apply(params, x, **kw)
moe.moe_apply = counted

for arch, shape in job["runs"]:
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    layout = fsdp.Layout(cfg, meshes[shape])
    params = layout.shard(convert.params_from_numpy(cfg, models[arch], "cpu"))
    opt = adamw_init(params)
    step = steps.make_train_step(cfg, layout=layout, **job["kw"])
    run = {"losses": [], "norms": []}
    held.clear()
    for b in job["batches"]:
        params, opt, m = step(params, opt, {k: torch.from_numpy(v) for k, v in b.items()})
        run["losses"].append(float(m["loss"]))
        run["norms"].append(float(m["grad_norm"]))
    run["held"] = sorted(set(held))
    whole = layout.full(params)
    if rank == 0:
        run["params"] = model.tree_map(N, whole)
    res["model"][arch, shape] = run
with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(res, f)
dist.destroy_process_group()
'''


def layer_weights(seed, shared):
    rng = np.random.default_rng(seed)

    def normal(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    w = {"router": normal(D, E, scale=1.0),
         "wi_gate": normal(E, D, FF, scale=D ** -0.5),
         "wi_up": normal(E, D, FF, scale=D ** -0.5),
         "wo": normal(E, FF, D, scale=FF ** -0.5)}
    if shared:
        w["shared"] = {"wi_gate": normal(D, FF, scale=D ** -0.5),
                       "wi_up": normal(D, FF, scale=D ** -0.5),
                       "wo": normal(FF, D, scale=FF ** -0.5)}
    return w


def lm_batch(vocab, seed):
    toks = np.random.default_rng(seed).integers(1, vocab, (BATCH, SEQ + 1)) \
        .astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def configs(arch):
    over = {"compute_dtype": "float32"}
    return (dataclasses.replace(jax_smoke(arch), **over),
            dataclasses.replace(get_smoke_config(arch), **over))


def jax_layer(name, factor, job):
    """JAX's ``moe_apply`` on the whole input: (y, aux, gradients of
    sum(y * w) + aux with respect to the weights and x)."""
    top_k, _ = LAYERS[name]

    def f(p, x):
        y, aux = jax_moe.moe_apply(p, x, top_k=top_k,
                                   capacity_factor=factor)
        return jnp.sum(y * job["w"]) + aux, (y, aux)

    p = jax.tree.map(jnp.asarray, job["weights"][name])
    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(p, jnp.asarray(job["x"]))
    return (np.asarray(y), float(aux),
            {"x": np.asarray(gx), **jax.tree.map(np.asarray, gp)})


def jax_first_loss(arch, weights, batch):
    """The loss JAX's ``make_train_step`` reports for ``batch``: the mean
    of ``loss_fn`` over its microbatches (``repro/models/steps.py``),
    here without the backward, whose compile alone takes jamba's smoke
    config 30 s."""
    jcfg, _ = configs(arch)
    loss = jax.jit(functools.partial(jax_steps.loss_fn, jcfg))
    jp = jax.tree.map(jnp.asarray, weights)
    n = KW["num_microbatches"]
    rows = BATCH // n
    return sum(float(loss(jp, {k: jnp.asarray(v[i * rows:(i + 1) * rows])
                               for k, v in batch.items()})[0])
               for i in range(n)) / n


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """(each rank's results, the job, JAX's layer results, JAX's first
    losses): the 4-rank gloo group starts on the layer cases while JAX
    draws the models' weights (``models.pkl``, which the ranks wait for)
    and computes its own results."""
    out = tmp_path_factory.mktemp("fsdp_moe")
    rng = np.random.default_rng(0)
    vocab = configs(ARCHS[0])[0].vocab_size
    job = {"layers": LAYERS, "factors": FACTORS,
           "layer_meshes": LAYER_MESHES,
           "weights": {n: layer_weights(i, shared) for i, (n, (_, shared))
                       in enumerate(LAYERS.items())},
           "x": rng.standard_normal((TOKENS, D)).astype(np.float32),
           "w": rng.standard_normal((TOKENS, D)).astype(np.float32),
           "runs": MODEL_RUNS, "kw": KW,
           "batches": [lm_batch(vocab, 10 + i) for i in range(STEPS)]}
    with open(out / "job.pkl", "wb") as f:
        pickle.dump(job, f)
    port = str(free_port())
    logs = [out / f"rank{r}.log" for r in range(WORLD)]
    procs = [_start([RANK_SCRIPT], logs[r], RANK=str(r),
                    WORLD_SIZE=str(WORLD), FSDP_PORT=port, FSDP_OUT=str(out))
             for r in range(WORLD)]
    try:
        models = {arch: jax.tree.map(np.asarray, jax_model.init_params(
            configs(arch)[0], jax.random.key(0))) for arch in ARCHS}
        with open(out / "models.tmp", "wb") as f:
            pickle.dump(models, f)
        os.replace(out / "models.tmp", out / "models.pkl")
        job["models"] = models
        want = {(n, f): jax_layer(n, f, job) for n in LAYERS
                for f in FACTORS}
        first = {arch: jax_first_loss(arch, models[arch],
                                      job["batches"][0]) for arch in ARCHS}
    finally:
        _wait(procs, logs, "the 4-rank MoE group")
    ranks = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, job, want, first


def assemble(runs):
    """The whole layer's results from each rank's: rows concatenated in
    block order, the aux shares and the replicated weights' gradients
    summed over the batch ranks, each expert's gradient summed over the
    batch ranks and the experts concatenated in ``model`` order."""
    first = sorted((r for r in runs if r["model_rank"] == 0),
                   key=lambda r: r["index"])
    out = {"y": np.concatenate([r["y"] for r in first]),
           "aux": sum(r["aux"] for r in first),
           "x": np.concatenate([r["x"] for r in first]),
           "router": sum(r["grads"]["router"] for r in first)}
    if "shared" in first[0]["grads"]:
        out["shared"] = {k: sum(r["grads"]["shared"][k] for r in first)
                         for k in first[0]["grads"]["shared"]}
    models = sorted({r["model_rank"] for r in runs})
    for k in ("wi_gate", "wi_up", "wo"):
        out[k] = np.concatenate([
            sum(r["grads"][k] for r in runs if r["model_rank"] == mi)
            for mi in models])
    return out


@pytest.mark.parametrize("shape", LAYER_MESHES)
@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("name", list(LAYERS))
def test_sharded_moe_layer_matches_jax(group, name, factor, shape):
    ranks, _, want, _ = group
    y, aux, grads = want[name, factor]
    got = assemble([r["layer"][name, factor, shape] for r in ranks])
    np.testing.assert_allclose(got["y"], y, rtol=Y_RTOL, atol=Y_ATOL)
    np.testing.assert_allclose(got["aux"], aux, rtol=AUX_RTOL)
    for k, g in grads.items():
        for kk, gg in (g.items() if k == "shared" else [(None, g)]):
            a = got[k][kk] if kk else got[k]
            tol = (TOP1_ROUTER_TOL if k == "router" and LAYERS[name][0] == 1
                   else GRAD_TOL)
            assert np.abs(a - gg).max() <= tol * np.abs(gg).max(), (k, kk)


@pytest.mark.parametrize("name", list(LAYERS))
def test_routing_each_rank_alone_misses_jax(group, name):
    """The control: at factor 0.5 on (4, 1), each rank routing its 64
    tokens alone (capacity from 64 tokens, ranks within its own) gives
    another output than the whole microbatch's routing."""
    ranks, _, want, _ = group
    y, _, _ = want[name, 0.5]
    got = np.concatenate([r["alone"][name, 0.5]["y"] for r in
                          sorted(ranks, key=lambda r: r["alone"][name, 0.5]
                                 ["index"])])
    assert not np.allclose(got, y, rtol=Y_RTOL, atol=Y_ATOL)


def one_process_steps(arch, weights, batches):
    _, cfg = configs(arch)
    params = convert.params_from_numpy(cfg, weights, "cpu")
    opt = adamw_init(params)
    step = steps.make_train_step(cfg, **KW)
    losses, norms = [], []
    for b in batches:
        params, opt, m = step(params, opt,
                              {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, [t.numpy() for t in model._leaves(params)]


@pytest.fixture(scope="module")
def one_process(group):
    _, job, _, _ = group
    return {arch: one_process_steps(arch, job["models"][arch], job["batches"])
            for arch in ARCHS}


@pytest.mark.parametrize("arch,shape", MODEL_RUNS)
def test_moe_model_trains_on_the_mesh(group, one_process, arch, shape):
    """Losses and grad norms on every rank, and the params after 2
    steps, against the one-process step; the first loss against JAX's
    step; each MoE layer ran with E/m experts."""
    ranks, _, _, first = group
    losses, norms, params = one_process[arch]
    for r in ranks:
        run = r["model"][arch, shape]
        np.testing.assert_allclose(run["losses"], losses, rtol=RTOL)
        np.testing.assert_allclose(run["norms"], norms, rtol=RTOL)
        assert run["held"] == [get_smoke_config(arch).num_experts
                               // shape[1]]
    got = ranks[0]["model"][arch, shape]["params"]
    for a, b in zip([np.asarray(t) for t in model._leaves(got)], params):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ranks[0]["model"][arch, shape]["losses"][0],
                               first[arch], rtol=RTOL)
