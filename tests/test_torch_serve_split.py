"""Serving over the ``("data", "model")`` mesh (``repro_torch/launch/
fsdp.py``'s ``ServeLayout``, ``launch/serve.py``'s ``serve_batch(...,
mesh=)``): the decode kernel's partial mode and its combine against the
JAX package's whole-cache ``decode_attention``, and the serve on four
gloo ranks, spawned once as ``tests/test_torch_tp.py`` spawns them,
against the one-process serve on the same weights and, for llama3-8b,
against the JAX package's ``serve_batch`` on its own weights carried
across by ``models/convert.py``.

Each rank serves ``CASES`` in turn (smoke configs with 8/4 heads, so that
m = 4 divides them, in float32): llama3-8b on (1, 4) and (2, 2), gemma2-9b
on (1, 4) (its window of 8 over 4 slices of 12 slots crosses them),
llama4-scout on (1, 4) (one of its 4 experts a rank, the shared expert
whole) and llama3-8b with one request on (2, 2), where the batch cannot
take ``data`` and the cache's sequence takes ``(data, model)``. The
tokens must equal the one-process serve's and the logits agree within
``LOGIT_ATOL``; each rank's caches must take the bytes the dry run
counts for it (``mesh.block_bytes`` of ``cache_specs``, a decode_32k-shaped
smoke cell); a Mamba-2 arch must raise ``ValueError`` naming it.
"""
import dataclasses
import importlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_spmd import _start, _wait, free_port
from test_torch_tp import PATH

import chip_smoke
from repro.configs import get_smoke_config as jax_smoke
from repro.launch import serve as jax_serve
from repro.models import attention as jax_attention
from repro.models import model as jax_model
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import decode_attention as dec_kernel
from repro_torch.kernels import ops, ref
from repro_torch.kernels.registry import KERNELS
from repro_torch.launch import fsdp
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve
from repro_torch.models import attention, convert, layers, model
from repro_torch.sharding import MeshShape

WORLD = 4
HEADS = {"num_heads": 8, "num_kv_heads": 4}
#: (arch, mesh, requests, generated tokens): the serves each rank runs,
#: in order. Prompts of 16 to 32 tokens and 16 generated take 48 slots,
#: 12 a slice; 15 generated take 47, which 4 does not divide, so the
#: last case keeps the sequence whole on every rank (``cache_specs``' rule)
#: and gathers prefill's heads instead of relaying slots
CASES = (("llama3-8b", (1, 4), 4, 16), ("llama3-8b", (2, 2), 4, 16),
         ("gemma2-9b", (1, 4), 4, 16),
         ("llama4-scout-17b-a16e", (1, 4), 4, 16),
         ("llama3-8b", (2, 2), 1, 16), ("llama3-8b", (1, 4), 4, 15))
IDS = [f"{a}-{'x'.join(map(str, m))}-b{b}-g{n}" for a, m, b, n in CASES]
TRAFFIC = dict(prompt_len=32, seed=3)
#: split against one process, float32, the largest |logit| difference:
#: the split re-associates the heads', the MLP columns' and the
#: vocabulary's sums and the combine weighs four slices' partials
#: (measured below 5e-6 on these cases)
LOGIT_ATOL = 1e-4
#: the JAX comparison: llama3-8b on (1, 4), the JAX package's weights
JAX_CASE = CASES[0]


def _cfgs(arch: str):
    """(JAX config, port config): the smoke config with 8/4 heads in
    float32."""
    over = {**HEADS, "compute_dtype": "float32"}
    return (dataclasses.replace(jax_smoke(arch), **over),
            dataclasses.replace(get_smoke_config(arch), **over))


# ---------------------------------------------------------------------------
# the partial mode and its combine
# ---------------------------------------------------------------------------

#: (B, Smax, Hkv, G, D), kv_len per row: row 0 lives in the first slice
#: only (the others get kv_len' <= 0), row 2 fills every slot (the first
#: slices get kv_len' > their slots), row 1 between
SHAPE = (3, 48, 2, 2, 16)
LENS = (5, 30, 48)


@pytest.mark.parametrize("slices", [1, 2, 4])
@pytest.mark.parametrize("window,softcap", [(None, None), (8, None),
                                            (20, 50.0), (3, None)])
def test_partial_decode_and_combine_match_jax_whole_cache(slices, window,
                                                          softcap):
    """Each slice's plain partial decode (``attention.decode_partial``)
    with the lengths shifted by its first slot, combined
    (``attention.combine_partials`` through ``fsdp.CacheSplit``'s
    stand-in), against JAX's ``decode_attention`` over the whole cache,
    float32, rtol 1e-5. Windows of 8 and 20 over slices of 12 or 24
    straddle them; with 4 slices row 0's last three slices hold no live
    slot, and a window of 3 leaves whole slices of rows 1 and 2 dead."""
    b, smax, hkv, g, d = SHAPE
    rng = np.random.default_rng(slices * 10 + (window or 0))
    q = rng.standard_normal((b, 1, hkv * g, d)).astype(np.float32)
    k = rng.standard_normal((b, smax, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, smax, hkv, d)).astype(np.float32)
    kv_len = np.asarray(LENS, np.int32)
    want = np.asarray(jax_attention.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_len=jnp.asarray(kv_len), window=window, logit_softcap=softcap))
    n = smax // slices
    ranges = [(r * n, (r + 1) * n) for r in range(slices)]
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tl = torch.from_numpy(kv_len)
    parts = [attention.decode_partial(
        tq, tk[:, lo:hi], tv[:, lo:hi], kv_len=tl - lo, window=window,
        logit_softcap=softcap, impl="dense") for lo, hi in ranges]
    if slices == 4 and window is None:
        dead = parts[3][1][0]          # row 0 on the last slice
        assert torch.isinf(dead).all() and not parts[3][0][0].any()
    got = attention.combine_partials(
        parts, fsdp.CacheSplit(None, ranges).reduce, torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_partial_mode_plain_version_and_entry_points():
    """``ref.decode_attention_partial``: o over the live slots normalised,
    lse their log-sum-exp, o = 0 and lse = -inf where none is live (a
    length of 0, a negative one); ``ops.decode_attention_partial`` on CPU
    tensors is it, in the JAX layouts; the kernel's wrapper on meta
    tensors checks the call and allocates o float32 and lse without
    launching."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(4, 2, 16, generator=gen)
    k = torch.randn(4, 10, 16, generator=gen)
    v = torch.randn(4, 10, 16, generator=gen)
    kl = torch.tensor([0, -3, 4, 25], dtype=torch.int32)
    o, lse = ref.decode_attention_partial(q, k, v, kl)
    assert torch.isinf(lse[:2]).all() and (lse[:2] < 0).all()
    assert not o[:2].any()
    s = torch.einsum("hgd,hkd->hgk", q * 16 ** -0.5, k)
    torch.testing.assert_close(lse[2], torch.logsumexp(s[2, :, :4], -1))
    torch.testing.assert_close(lse[3], torch.logsumexp(s[3], -1))
    torch.testing.assert_close(
        o[3], torch.softmax(s[3], -1) @ v[3], rtol=1e-5, atol=1e-6)
    qb = q.reshape(2, 1, 4, 16)
    kb = k.reshape(2, 2, 10, 16).transpose(1, 2)
    vb = v.reshape(2, 2, 10, 16).transpose(1, 2)
    o2, lse2 = ops.decode_attention_partial(qb, kb, vb,
                                            torch.tensor([5, 9],
                                                         dtype=torch.int32))
    w_o, w_l = ref.decode_attention_partial(
        q, k, v, torch.tensor([5, 5, 9, 9], dtype=torch.int32))
    torch.testing.assert_close(o2.reshape(4, 2, 16), w_o)
    torch.testing.assert_close(lse2.reshape(4, 2), w_l)
    before = dec_kernel.decode_attention_partial_bhgd.launches
    mo, ml = dec_kernel.decode_attention_partial_bhgd(
        q.to("meta", torch.bfloat16), k.to("meta", torch.bfloat16),
        v.to("meta", torch.bfloat16), kl.to("meta"))
    assert mo.dtype == torch.float32 and mo.shape == q.shape
    assert ml.dtype == torch.float32 and ml.shape == q.shape[:2]
    assert dec_kernel.decode_attention_partial_bhgd.launches == before
    # the registry lists the mode under its kernel, naming these two
    mode = KERNELS["decode_attention"]["modes"]["decode_attention_partial"]
    mod, fn = mode["wrapper"].split(".")
    assert getattr(importlib.import_module(f"repro_torch.kernels.{mod}"),
                   fn) is dec_kernel.decode_attention_partial_bhgd
    assert getattr(ref, mode["plain"]) is ref.decode_attention_partial


def test_serve_specs_hold_unsplit_leaves_whole():
    """On (1, 4) llama4-scout's serve keeps ``model`` on the split heads'
    columns and wo's rows, the experts and the vocabulary, and holds the
    norms, the router and the shared expert whole."""
    cfg = get_smoke_config("llama4-scout-17b-a16e")
    cfg = dataclasses.replace(cfg, **HEADS)
    mesh = MeshShape((1, 4), ("data", "model"))
    specs = mesh_lib.param_specs(cfg, mesh)
    split = [fsdp.split_sublayers(cfg, s, 4) for s in specs["layers"]]
    sv = fsdp.serve_specs(specs, split, fsdp.vocab_splits(specs, 4))
    layer = sv["layers"][0]
    assert split[0] == ("attn",)
    assert layer["attn"]["wq"][1] == "model" and layer["attn"]["wo"][0] \
        == "model"
    assert layer["moe"]["wi_gate"][0] == "model"
    assert sv["embed"][0] == "model" and sv["lm_head"][1] == "model"
    whole = [layer["moe"]["router"], layer["ln_mixer"]["scale"],
             *model._leaves(layer["moe"]["shared"])]
    assert all("model" not in str(s) for s in whole)
    assert specs["layers"][0]["moe"]["shared"]["wi_gate"][0] == "model"


@pytest.mark.parametrize("arch", ["llama3-8b", "gemma2-9b",
                                  "llama4-scout-17b-a16e"])
def test_phase18_rehearsal(arch):
    """``chip_smoke.serve_split_path`` (phase 18) at the smoke config
    with 8/4 heads on the CPU: one layer's decode step split four ways in
    turn against the whole layer's, float32 and bf16, the relayout bit
    for bit, the split argmax with ties."""
    rec = chip_smoke.serve_split_path(torch.device("cpu"), arch, smoke=True,
                                      overrides=HEADS, requests=4,
                                      prompt_len=32, gen_len=16)
    assert rec["float32"]["worst"] <= chip_smoke.SERVE_SPLIT_TOL["float32"]
    assert rec["relayout"]["bit_for_bit"]
    assert [r[1] - r[0] for r in rec["float32"]["slices"]] == [12] * 4


def test_split_argmax_resolves_ties_as_argmax():
    """Ties across and within vocabulary blocks go to the lowest index,
    as ``torch.argmax`` of the whole does."""
    x = torch.zeros(3, 16)
    x[0, [2, 9]] = 5.0
    x[1, [7, 8]] = 5.0
    x[2, 15] = 1.0
    ranges = [(0, 4), (4, 8), (8, 12), (12, 16)]
    got = layers.split_argmax([x[:, lo:hi] for lo, hi in ranges],
                              fsdp.VocabSplit(None, ranges))
    assert got.tolist() == torch.argmax(x, -1).tolist() == [2, 7, 15]


# ---------------------------------------------------------------------------
# four gloo ranks
# ---------------------------------------------------------------------------

RANK_SCRIPT = r'''
import os, pickle
from datetime import timedelta
import torch
import torch.distributed as dist
from repro_torch.configs import input_specs
from repro_torch.launch import fsdp
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve
from repro_torch.models import convert, model

rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
out = os.environ["SERVE_OUT"]
torch.set_num_threads(1)       # four ranks share the worker's cores
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + os.environ["SERVE_PORT"],
                        rank=rank, world_size=world, timeout=timedelta(seconds=90))
with open(os.path.join(out, "job.pkl"), "rb") as f:
    job = pickle.load(f)
meshes = {}
res = {}
for case in job["cases"]:
    arch, shape, n, gen = case
    cfg = job["cfgs"][arch]
    if shape not in meshes:
        meshes[shape] = mesh_lib.make_mesh(shape, "cpu")
    mesh = meshes[shape]
    params = convert.params_from_numpy(cfg, job["weights"][arch], "cpu")
    got = serve.serve_batch(arch, num_requests=n, gen_len=gen, device="cpu",
                            params=params, overrides=job["over"], mesh=mesh,
                            **job["traffic"])
    served = fsdp.ServeLayout(cfg, mesh, n, job["traffic"]["prompt_len"] + gen)
    # a decode_32k-shaped cell at the smoke size: the caches a rank
    # allocates against the dry run's per-device bytes
    spec = input_specs(cfg, "decode_32k", batch=8 if n > 1 else 1, seq=64)
    layout = fsdp.ServeLayout(cfg, mesh, 8 if n > 1 else 1, 64)
    mine = model.init_cache(cfg, 8 if n > 1 else 1, 64, "cpu", layout)
    # the blocks a rank keeps as the seeded weights are drawn, against
    # its blocks of the whole that one process draws
    kept = model.init_params(cfg, 5, "cpu", keep=layout.keep)
    cut = layout.shard(model.init_compute_params(cfg, 5, "cpu"))
    res[case] = {
        "blocks_equal": all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(model._leaves(kept), model._leaves(cut))),
        "kept_numel": sum(t.numel() for t in model._leaves(kept)),
        "generated": got["generated"],
        "prefill_logits": got["prefill_logits"].numpy(),
        "step_logits": got["step_logits"].numpy(),
        "cache_bytes": sum(t.numel() * t.element_size()
                           for t in model._leaves(mine)),
        "dryrun_bytes": mesh_lib.block_bytes(
            spec["caches"], mesh_lib.cache_specs(cfg, mesh, spec["caches"]),
            mesh),
        "kv_spec": layout.kv_spec, "slots": layout.cache.ranges,
        "batch_spec": layout.batch_spec,
        "serve_slots": served.cache.ranges,
        "serve_split": served.cache.split}
try:
    fsdp.ServeLayout(job["mamba"], meshes[(1, 4)], 4, 48)
    res["mamba"] = None
except ValueError as e:
    res["mamba"] = str(e)
with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(res, f)
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def weights():
    """{arch: the JAX package's initial weights (float32 numpy)} of the
    cases' configs."""
    out = {}
    for arch in dict.fromkeys(a for a, *_ in CASES):
        jcfg, _ = _cfgs(arch)
        out[arch] = jax.tree.map(np.asarray, jax_model.init_params(
            jcfg, jax.random.key(TRAFFIC["seed"])))
    return out


@pytest.fixture(scope="module")
def ranks(weights, tmp_path_factory):
    """Each rank's results of the 4-rank gloo group."""
    out = tmp_path_factory.mktemp("serve")
    with open(out / "job.pkl", "wb") as f:
        pickle.dump({"cases": CASES, "weights": weights,
                     "cfgs": {a: _cfgs(a)[1] for a in weights},
                     "over": {**HEADS, "compute_dtype": "float32"},
                     "traffic": TRAFFIC,
                     "mamba": get_smoke_config("mamba2-370m")}, f)
    port = str(free_port())
    logs = [out / f"rank{r}.log" for r in range(WORLD)]
    procs = [_start([RANK_SCRIPT], logs[r], RANK=str(r),
                    WORLD_SIZE=str(WORLD), SERVE_PORT=port,
                    SERVE_OUT=str(out), PYTHONPATH=PATH)
             for r in range(WORLD)]
    _wait(procs, logs, "the 4-rank serving group")
    res = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_serve_matches_one_process(ranks, weights, case):
    """Every rank returns the one-process serve's tokens for the whole
    batch, and its logits within LOGIT_ATOL, on the same weights."""
    arch, _, n, gen = case
    _, cfg = _cfgs(arch)
    one = serve.serve_batch(
        arch, num_requests=n, gen_len=gen, device="cpu",
        params=convert.params_from_numpy(cfg, weights[arch], "cpu"),
        overrides={**HEADS, "compute_dtype": "float32"}, **TRAFFIC)
    for r in ranks:
        got = r[case]
        np.testing.assert_array_equal(got["generated"], one["generated"])
        for key in ("prefill_logits", "step_logits"):
            assert got[key].shape == tuple(one[key].shape)
            assert np.abs(got[key] - one[key].numpy()).max() <= LOGIT_ATOL


def test_split_serve_matches_jax(ranks, weights, monkeypatch):
    """llama3-8b on (1, 4) against the JAX package's ``serve_batch`` on
    its own weights (the same requests: both draw them from one numpy
    generator): the generated tokens equal."""
    arch = JAX_CASE[0]
    jcfg, _ = _cfgs(arch)
    monkeypatch.setattr(jax_serve, "get_smoke_config", lambda a: jcfg)
    want = jax_serve.serve_batch(arch, num_requests=JAX_CASE[2],
                                 gen_len=JAX_CASE[3], **TRAFFIC)
    np.testing.assert_array_equal(ranks[0][JAX_CASE]["generated"],
                                  want["generated"])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_rank_caches_are_the_dry_runs_bytes(ranks, case):
    """Each rank's caches for a decode_32k-shaped smoke cell (batch 8, or
    1 where the case serves one request, 64 slots) take the bytes that
    the dry run counts a device (``mesh.block_bytes`` of
    ``cache_specs``), a quarter of the whole caches."""
    arch, _, n, _ = case
    _, cfg = _cfgs(arch)
    whole = sum(t.numel() * t.element_size() for t in model._leaves(
        model.init_cache(cfg, 8 if n > 1 else 1, 64, "meta")))
    for r in ranks:
        assert r[case]["cache_bytes"] == r[case]["dryrun_bytes"] \
            == whole // WORLD


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_rank_weights_are_blocks_of_the_seeded_whole(ranks, case):
    """The weights each rank keeps as they are drawn
    (``ServeLayout.keep``) equal, dtype and bits, its blocks of the whole
    that one process draws from the seed (``ServeLayout.shard`` of
    ``model.init_compute_params``), and the ranks together hold more than
    a quarter of the whole (the norms, and llama4's router and shared
    expert, whole on every rank) and less than all of it."""
    arch = case[0]
    _, cfg = _cfgs(arch)
    whole = cfg.num_params()
    assert all(r[case]["blocks_equal"] for r in ranks)
    assert whole / WORLD < ranks[0][case]["kept_numel"] < whole


def test_cache_sequence_takes_data_for_one_request(ranks):
    """One request on (2, 2): the batch stays whole, the sequence splits
    over (data, model) and the four ranks hold its four slot blocks."""
    case = CASES[4]
    assert ranks[0][case]["batch_spec"][0] is None
    assert ranks[0][case]["kv_spec"][1] == ("data", "model")
    assert sorted(r[case]["slots"][0] for r in ranks) == [
        (0, 16), (16, 32), (32, 48), (48, 64)]


def test_sequence_stays_whole_where_four_does_not_divide_it(ranks):
    """47 slots on (1, 4): every rank keeps the whole sequence, and no
    combine runs (its serve matches one process above); 48 split four
    ways."""
    assert all(r[CASES[5]]["serve_slots"] == ((0, 47),)
               and not r[CASES[5]]["serve_split"] for r in ranks)
    assert sorted(r[CASES[0]]["serve_slots"][0] for r in ranks) == [
        (0, 12), (12, 24), (24, 36), (36, 48)]


def test_mamba_arch_raises(ranks):
    """A Mamba-2 model does not serve over the mesh: ``ValueError``
    naming it, on every rank."""
    for r in ranks:
        assert r["mamba"] is not None and "mamba2-370m" in r["mamba"]
