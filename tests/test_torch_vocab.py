"""The vocabulary split over ``model`` (``repro_torch/launch/fsdp.py``'s
``VocabSplit`` and ``vocab_in_turn``; ``models/model.py``'s
``_embed_tokens`` and ``models/layers.py``'s
``chunked_cross_entropy_sums`` given the split) on one device: every
rank's share computed in turn, the max, the sums and the gold logit
combined in rank order as the all-reduces would.

At m = 1, 2 and 4 (m = 1 splits nothing), on seeded inputs at the smoke
width (V 128, d 64, 40 tokens in 4 chunks) whose labels include -1 and
the first and last row of every rank's block:

* the split lookup equals the whole lookup bit for bit, and so does the
  table's gradient through it;
* the split loss sums, their input gradient and the table's gradient
  agree with the whole loss's, in float32 and bfloat16, with and without
  a final softcap, each gradient's largest difference over its largest
  |value| within ``TOL``;
* in float32 the split loss matches JAX's ``chunked_cross_entropy_loss``
  (``repro/models/layers.py``) at rtol 1e-5, and its gradients JAX's
  within ``TOL``.

A V that m does not divide stays whole (``vocab_in_turn`` gives the
table back with no split), as granite's 49155 does at its published
config.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import fsdp
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import layers, model
from repro_torch.sharding import MeshShape

ARCH = "llama3-8b"
TOKENS, CHUNKS, SOFTCAP = 40, 4, 30.0
# each gradient's largest difference over its largest |value|, split
# against whole. float32: the split re-associates the sum of exp over
# the blocks and the input gradient's sum over them (measured 6.9e-7 at
# most, 5.8e-7 against JAX; the loss 9.3e-8 relative); bfloat16: the summed input gradient is rounded once from
# float32 partials where the whole product rounds its own accumulators,
# so an element can land one bf16 step (3.9e-3 relative) away (measured
# equal on these inputs)
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
JAX_RTOL = 1e-5


def _cfg(dtype: str = "float32"):
    return dataclasses.replace(get_smoke_config(ARCH), compute_dtype=dtype)


def _inputs(cfg, m: int, seed: int = 0):
    """(table float32 (V, d), x float32 (T, d), labels (T,), tokens
    (2, 16)): the labels and tokens hold -1 (labels only) and the first
    and last row of each of the m blocks."""
    rng = np.random.default_rng(seed)
    v, d = cfg.vocab_size, cfg.d_model
    table = rng.normal(0.0, 0.5, (v, d)).astype(np.float32)
    x = rng.normal(0.0, 1.0, (TOKENS, d)).astype(np.float32)
    edges = [e for r in range(m) for e in (r * v // m, (r + 1) * v // m - 1)]
    labels = rng.integers(0, v, TOKENS)
    labels[:3] = -1
    labels[3:3 + len(edges)] = edges
    tokens = rng.integers(0, v, (2, 16))
    tokens[0, :len(edges)] = edges
    return table, x, labels.astype(np.int64), tokens


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max())


def _loss(cfg, table, x, labels, m, softcap, split: bool):
    """((tot, cnt), d/dx, d/dtable) of the chunked loss on ``table`` cast
    to the compute dtype, split over m ranks in turn or whole."""
    t = torch.from_numpy(table).requires_grad_()
    xt = torch.from_numpy(x).to(cfg.cdtype).requires_grad_()
    emb = t.to(cfg.cdtype)
    vocab = None
    if split:
        emb, vocab = fsdp.vocab_in_turn(cfg, emb, m)
    tot, cnt = layers.chunked_cross_entropy_sums(
        xt, emb, torch.from_numpy(labels), CHUNKS, softcap, vocab=vocab)
    gx, gt = torch.autograd.grad(tot / cnt, [xt, t])
    return (tot.detach(), cnt), gx, gt


@pytest.mark.parametrize("softcap", (None, SOFTCAP), ids=("nocap", "cap"))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("m", (1, 2, 4))
def test_split_loss_matches_whole(m, dtype, softcap):
    cfg = _cfg(dtype)
    table, x, labels, _ = _inputs(cfg, m)
    (tot0, cnt0), gx0, gt0 = _loss(cfg, table, x, labels, m, softcap, False)
    (tot1, cnt1), gx1, gt1 = _loss(cfg, table, x, labels, m, softcap, True)
    assert float(cnt1) == float(cnt0) == TOKENS - 3
    torch.testing.assert_close(tot1, tot0, rtol=1e-6, atol=0)
    assert _rel(gx1, gx0) <= TOL[dtype]
    assert _rel(gt1, gt0) <= TOL[dtype]
    if m == 1:                       # nothing splits: the same arithmetic
        assert torch.equal(tot1, tot0) and torch.equal(gx1, gx0)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("m", (1, 2, 4))
def test_split_lookup_is_the_whole_lookup(m, dtype):
    """The rows, cast to the compute dtype, equal the whole table's bit
    for bit; the table's gradient from a seeded output gradient too, and
    it lands on the looked-up rows only."""
    cfg = _cfg(dtype)
    table, _, _, tokens = _inputs(cfg, m)
    tok = torch.from_numpy(tokens)
    dy = torch.from_numpy(np.random.default_rng(1).normal(
        size=tokens.shape + (cfg.d_model,)).astype(np.float32)).to(cfg.cdtype)

    def run(split: bool):
        t = torch.from_numpy(table).requires_grad_()
        blocks, vocab = (fsdp.vocab_in_turn(cfg, t, m) if split
                         else (t, None))
        rows = model._embed_tokens(cfg, {"embed": blocks}, tok, vocab)
        return rows, torch.autograd.grad(rows, t, dy)[0]

    rows0, g0 = run(False)
    rows1, g1 = run(True)
    assert rows1.dtype == cfg.cdtype
    assert torch.equal(rows1, rows0)
    assert torch.equal(g1, g0)
    unused = np.setdiff1d(np.arange(cfg.vocab_size), tokens)
    assert not g1[torch.from_numpy(unused)].any()


@pytest.mark.parametrize("softcap", (None, SOFTCAP), ids=("nocap", "cap"))
@pytest.mark.parametrize("m", (2, 4))
def test_split_loss_matches_jax(m, softcap):
    cfg = _cfg("float32")
    table, x, labels, _ = _inputs(cfg, m)
    (tot, cnt), gx, gt = _loss(cfg, table, x, labels, m, softcap, True)

    def jloss(xj, tj):
        return jax_layers.chunked_cross_entropy_loss(
            xj, tj, jnp.asarray(labels), CHUNKS, softcap)

    want, (jgx, jgt) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(table))
    np.testing.assert_allclose(float(tot / cnt), float(want), rtol=JAX_RTOL)
    assert _rel(gx, torch.from_numpy(np.array(jgx))) <= TOL["float32"]
    assert _rel(gt, torch.from_numpy(np.array(jgt))) <= TOL["float32"]


@pytest.mark.parametrize("m", (2, 4))
def test_vocab_that_m_does_not_divide_stays_whole(m):
    """V 129 (smoke) and granite's 49155 (published): no split; the
    table comes back as it was and the layout's rule agrees."""
    cfg = dataclasses.replace(_cfg(), vocab_size=129)
    table = torch.zeros(129, cfg.d_model)
    blocks, vocab = fsdp.vocab_in_turn(cfg, table, m)
    assert vocab is None and blocks is table
    mesh = MeshShape((1, m), ("data", "model"))
    for c in (cfg, get_config("granite-moe-1b-a400m")):
        assert not fsdp.vocab_splits(mesh_lib.param_specs(c, mesh), m)
    assert fsdp.vocab_splits(mesh_lib.param_specs(_cfg(), mesh), m)


# the bfloat16 table gradient of a lookup whose 128 tokens repeat each
# of 8 rows 16 times: the reference casts the table, then takes the rows
# (``repro/models/model.py``'s ``_embed_inputs``), so its gradient sums
# each row's 16 bf16 output gradients in bfloat16; the port takes the
# rows, then casts, so it sums them in float32. Each gradient's largest
# difference over the other's largest |value| (measured: the port
# against the float32 sum 0, the reference against the port 9.55e-3,
# a few bf16 steps of a row's sum)
EMBED_GRAD_TOL = {"float32 sum": 1e-6, "jax": 2e-2}


def test_bf16_table_gradient_sums_in_float32():
    """The port's bf16 lookup gives the table the float32 sum of each
    row's gradients (``EMBED_GRAD_TOL``), where the reference's bf16
    scatter rounds as it sums; both agree with the other within a bf16
    step, and the port is the closer to the float32 sum."""
    cfg = _cfg("bfloat16")
    rng = np.random.default_rng(3)
    table = rng.normal(0.0, 0.5, (cfg.vocab_size, cfg.d_model)).astype(
        np.float32)
    tokens = np.repeat(np.arange(8), 16).reshape(2, 64)
    rng.shuffle(tokens.reshape(-1))
    dy = rng.normal(0.0, 1.0, tokens.shape + (cfg.d_model,)).astype(
        np.float32)
    dy = np.array(jnp.asarray(dy, jnp.bfloat16).astype(jnp.float32))

    t = torch.from_numpy(table).requires_grad_()
    h, _ = model._embed_inputs(cfg, {"embed": t},
                               {"tokens": torch.from_numpy(tokens)})
    assert h.dtype == torch.bfloat16
    got = torch.autograd.grad(h, t, torch.from_numpy(dy).to(h.dtype))[0]

    jcfg = dataclasses.replace(jax_smoke(ARCH), compute_dtype="bfloat16")
    _, vjp = jax.vjp(lambda e: jax_model._embed_inputs(
        jcfg, {"embed": e}, {"tokens": jnp.asarray(tokens)})[0],
        jnp.asarray(table))
    jgot, = vjp(jnp.asarray(dy, jnp.bfloat16))

    want = np.zeros_like(table)
    np.add.at(want, tokens.reshape(-1), dy.reshape(-1, cfg.d_model))
    want = torch.from_numpy(want)
    jgot = torch.from_numpy(np.array(jgot, np.float32))
    assert _rel(got, want) <= EMBED_GRAD_TOL["float32 sum"]
    assert _rel(jgot, got) <= EMBED_GRAD_TOL["jax"]
    assert _rel(got, want) < _rel(jgot, want)
