"""The port's training path (``repro_torch.models.steps``, ``optim``,
``models.flops``, ``data.pipeline``, ``launch.train``) against the JAX
package on the CPU, at the smoke size of the configs (2 layers per
period, d_model 64, 4/2 heads, head_dim 16, vocab 128), with the JAX
weights and optimizer state carried across by ``models/convert.py``;
and the plain flash-attention backward against JAX's autodiff.

Tolerances (float32 compute throughout): losses rtol 1e-5 and each
leaf's gradient within 1e-4 of that leaf's largest |g| (the two
frameworks sum in other orders over 32 tokens); AdamW on the same
gradients within 1e-6; three train steps' losses rtol 1e-4 (the
updates of each step feed the next); the flash backward atol/rtol 2e-5
(as tests/test_torch_kernels.py holds the forward to the Pallas
kernel).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.kernels import ref as jax_ref
from repro.models import attention as jax_attn
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro.models import steps as jax_steps
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import flash_attention, ops, ref
from repro_torch.models import convert, flops, layers, model, steps
from repro_torch.optim import adamw, schedule

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4            # of each leaf's largest |g|
ADAM_ATOL = 1e-6
TRAIN_RTOL = 1e-4
ATT_TOL = 2e-5
DENSE_ARCHS = ["qwen3-1.7b", "llama3-8b", "gemma2-9b", "gemma3-12b"]
# the MoE and Mamba-2 blocks; their moe_aux is held to LOSS_RTOL
NEW_ARCHS = ["granite-moe-1b-a400m", "llama4-scout-17b-a16e", "mamba2-370m",
             "jamba-v0.1-52b"]


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def N(t):
    return t.detach().float().numpy()


def configs(arch, **over):
    """(JAX config, port config) of one smoke arch in float32 compute,
    the same overrides."""
    over = {"compute_dtype": "float32", **over}
    return (dataclasses.replace(jax_smoke(arch), **over),
            dataclasses.replace(get_smoke_config(arch), **over))


def carried(jcfg, pcfg, seed=0):
    jp = jax_model.init_params(jcfg, jax.random.key(seed))
    return jp, convert.params_from_numpy(pcfg, jax.tree.map(np.asarray, jp),
                                         device="cpu")


def lm_batch(vocab, b=2, s=16, seed=0):
    toks = np.random.default_rng(seed).integers(1, vocab, (b, s + 1)) \
        .astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def assert_grads_close(pcfg, got, want, tol=GRAD_TOL):
    """Port gradients (its tree) against JAX ones (the JAX tree), each
    leaf within ``tol`` of its own largest |g|."""
    got = convert.params_to_numpy(pcfg, got)
    flat_w, _ = jax.tree_util.tree_flatten_with_path(want)
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_g) == len(flat_w)
    for path, w in flat_w:
        w = np.asarray(w)
        g = flat_g[path]
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, (jax.tree_util.keystr(path), err, scale)


# ---------------------------------------------------------------------------
# losses, schedule, optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [None, 30.0])
@pytest.mark.parametrize("t,chunks", [(24, 4), (21, 4), (16, 1)])
def test_cross_entropy_losses_match_jax(cap, t, chunks):
    """Both losses, with and without softcap, labels -1 ignored, a
    ragged T padded to the chunk count."""
    rng = np.random.default_rng(t + chunks)
    x = rng.normal(size=(t, 16)).astype(np.float32)
    emb = rng.normal(size=(40, 16)).astype(np.float32) * 0.5
    labels = rng.integers(0, 40, t).astype(np.int32)
    labels[::5] = -1
    want = jax_layers.chunked_cross_entropy_loss(
        jnp.asarray(x), jnp.asarray(emb), jnp.asarray(labels),
        num_chunks=chunks, final_softcap=cap)
    got = layers.chunked_cross_entropy_loss(T(x), T(emb), T(labels),
                                            num_chunks=chunks,
                                            final_softcap=cap)
    np.testing.assert_allclose(N(got), np.asarray(want), rtol=LOSS_RTOL)
    logits = x @ emb.T
    mask = (labels >= 0).astype(np.float32)
    safe = np.maximum(labels, 0)
    for m in (None, mask):
        want = jax_layers.cross_entropy_loss(
            jnp.asarray(logits), jnp.asarray(safe),
            None if m is None else jnp.asarray(m))
        got = layers.cross_entropy_loss(T(logits), T(safe),
                                        None if m is None else T(m))
        np.testing.assert_allclose(N(got), np.asarray(want), rtol=LOSS_RTOL)


def test_chunked_loss_gradient_matches_jax():
    """The chunked loss's gradients (its chunks recomputed in the
    backward) against jax.grad."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(21, 16)).astype(np.float32)
    emb = rng.normal(size=(40, 16)).astype(np.float32) * 0.5
    labels = rng.integers(-1, 40, 21).astype(np.int32)
    want = jax.grad(lambda a, b: jax_layers.chunked_cross_entropy_loss(
        a, b, jnp.asarray(labels), num_chunks=4, final_softcap=30.0),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(emb))
    xt, et = T(x).requires_grad_(), T(emb).requires_grad_()
    layers.chunked_cross_entropy_loss(xt, et, T(labels), num_chunks=4,
                                      final_softcap=30.0).backward()
    for g, w in zip((xt.grad, et.grad), want):
        np.testing.assert_allclose(N(g), np.asarray(w), atol=1e-6, rtol=1e-5)


def test_warmup_cosine_matches_jax():
    from repro.optim import warmup_cosine as jax_wc
    kw = dict(peak_lr=3e-4, warmup_steps=5, total_steps=17)
    for s in range(21):
        want = jax_wc(jnp.int32(s), **kw)
        got = schedule.warmup_cosine(torch.tensor(s, dtype=torch.int32),
                                     **kw)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-6)


def test_adamw_update_matches_jax():
    """Three updates fed the same gradients (clipping on, decay where
    the JAX layout has ndim >= 2: ``model.decay_mask``), from a JAX state
    carried across; without the mask, the port's per-layer norm scales
    (ndim 1) are not decayed and differ."""
    from repro.optim import adamw_init as jax_init
    from repro.optim import adamw_update as jax_update
    jcfg, pcfg = configs("qwen3-1.7b")
    jp, pp = carried(jcfg, pcfg)
    jopt = jax_init(jp)
    popt = convert.opt_state_from_numpy(
        pcfg, jax.tree.map(np.asarray, jopt), device="cpu")
    rng = np.random.default_rng(0)
    jax_update = jax.jit(functools.partial(jax_update, lr=1e-2))
    for i in range(3):
        g = jax.tree.map(lambda a: jnp.asarray(
            rng.normal(size=a.shape).astype(np.float32) * (0.3 + i)), jp)
        pg = convert.params_from_numpy(pcfg, jax.tree.map(np.asarray, g),
                                       device="cpu")
        jp, jopt, jm = jax_update(g, jopt, jp)
        pp, popt, pm = adamw.adamw_update(pg, popt, pp, lr=1e-2,
                                          decay_mask=model.decay_mask(pp))
        np.testing.assert_allclose(N(pm["grad_norm"]),
                                   np.asarray(jm["grad_norm"]), rtol=1e-6)
    assert int(popt["step"]) == 3 and popt["step"].dtype == torch.int32
    for got, want in ((pp, jp), (popt["m"], jopt["m"]),
                      (popt["v"], jopt["v"])):
        got = convert.params_to_numpy(pcfg, got)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a, np.asarray(b), atol=ADAM_ATOL,
                                       rtol=0)


def test_int8_compression_matches_jax():
    from repro.optim.adamw import compress_int8 as jax_c
    g = np.random.default_rng(1).normal(size=(50,)).astype(np.float32)
    q, s = adamw.compress_int8(T(g))
    jq, js = jax_c(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(N(adamw.decompress_int8(q, s)),
                               np.asarray(jq, np.float32) * np.asarray(js),
                               rtol=1e-6)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_opt_state_round_trip_exact_moe_and_ssm(arch):
    """The AdamW state of the MoE and Mamba-2 trees (stacked experts,
    the router, a_log, D, conv_w, ...) goes across and back exactly."""
    from repro.optim import adamw_init as jax_init
    jcfg, pcfg = configs(arch)
    jp = jax.jit(functools.partial(jax_model.init_params, jcfg))(
        jax.random.key(2))
    st = jax.tree.map(np.asarray, jax_init(jp))
    st["m"] = jax.tree.map(lambda a: a + 1.5, st["m"])
    st["v"] = jax.tree.map(lambda a: a * 0.5 + 0.25, st["v"])
    port = convert.opt_state_from_numpy(pcfg, st, device="cpu")
    assert set(port["m"]["layers"][0]) == set(st["m"]["blocks"][0])
    back = convert.opt_state_to_numpy(pcfg, port)
    flat_a = jax.tree_util.tree_leaves_with_path(st)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_opt_state_round_trip_exact():
    from repro.optim import adamw_init as jax_init
    jcfg, pcfg = configs("gemma3-12b")
    jp, _ = carried(jcfg, pcfg)
    st = jax.tree.map(np.asarray, jax_init(jp))
    st["m"] = jax.tree.map(lambda a: a + 1.5, st["m"])
    back = convert.opt_state_to_numpy(
        pcfg, convert.opt_state_from_numpy(pcfg, st, device="cpu"))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(st)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# gradients and train steps
# ---------------------------------------------------------------------------

@functools.cache
def jax_value_and_grad(arch):
    """jax.value_and_grad of the JAX loss_fn (dense attention) on the
    carried weights (seed 1) and ``lm_batch(seed=2)``; shared by both
    routes of the port."""
    jcfg, _ = configs(arch, attn_impl="dense")
    jp = jax_model.init_params(jcfg, jax.random.key(1))
    bt = lm_batch(jcfg.vocab_size, seed=2)
    (wl, wparts), wg = jax.jit(jax.value_and_grad(
        functools.partial(jax_steps.loss_fn, jcfg), has_aux=True))(
        jp, jax.tree.map(jnp.asarray, bt))
    return wl, wparts, wg


@pytest.mark.parametrize("impl", ["dense", "kernel"])
@pytest.mark.parametrize("arch", DENSE_ARCHS + NEW_ARCHS)
def test_value_and_grad_matches_jax(arch, impl):
    """loss, its parts and every leaf's gradient against
    jax.value_and_grad of the JAX loss_fn (dense attention).
    ``impl="kernel"`` takes the port's flash entry point: the autograd
    function with the plain forward and backward on the CPU."""
    jcfg, pcfg = configs(arch, attn_impl="dense")
    pcfg = dataclasses.replace(pcfg, attn_impl=impl)
    _, pp = carried(jcfg, pcfg, seed=1)
    bt = lm_batch(jcfg.vocab_size, seed=2)
    wl, wparts, wg = jax_value_and_grad(arch)
    loss, parts, grads = steps.value_and_grad(
        pcfg, pp, {k: T(v) for k, v in bt.items()})
    np.testing.assert_allclose(N(loss), np.asarray(wl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(N(parts["ce"]), np.asarray(wparts["ce"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(N(parts["moe_aux"]),
                               np.asarray(wparts["moe_aux"]), rtol=LOSS_RTOL)
    assert (float(parts["moe_aux"]) > 0) == (pcfg.num_experts > 0)
    assert_grads_close(pcfg, grads, wg)
    # every parameter receives a gradient (the attention's included)
    for leaf in model._leaves(grads):
        assert float(leaf.abs().max()) > 0


def test_flash_autograd_gives_every_parameter_a_gradient():
    """On the kernel route (plain versions on the CPU) the attention's
    weights and norms get their gradients from FlashAttention's
    backward: the same as the dense route's."""
    _, pcfg = configs("qwen3-1.7b")
    pp = model.init_params(pcfg, 3, "cpu")
    bt = {k: T(v) for k, v in lm_batch(pcfg.vocab_size, seed=4).items()}
    fa = flash_attention.FlashAttention
    calls = []
    real = fa.backward

    def counting(ctx, do):
        calls.append(do.shape)
        return real(ctx, do)

    fa.backward = staticmethod(counting)
    try:
        _, _, got = steps.value_and_grad(
            dataclasses.replace(pcfg, attn_impl="kernel"), pp, bt)
    finally:
        fa.backward = staticmethod(real)
    assert len(calls) == pcfg.num_layers
    _, _, want = steps.value_and_grad(
        dataclasses.replace(pcfg, attn_impl="dense"), pp, bt)
    for layer in got["layers"]:
        for name in ("wq", "wk", "wv", "q_norm", "k_norm"):
            assert float(layer["attn"][name].abs().max()
                         if name[0] == "w" else
                         layer["attn"][name]["scale"].abs().max()) > 0
    for a, b in zip(model._leaves(got), model._leaves(want)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)


def test_remat_gives_the_same_grads():
    _, pcfg = configs("gemma2-9b")
    pp = model.init_params(pcfg, 5, "cpu")
    bt = {k: T(v) for k, v in lm_batch(pcfg.vocab_size, seed=6).items()}
    on = steps.value_and_grad(dataclasses.replace(pcfg, remat=True), pp, bt)
    off = steps.value_and_grad(dataclasses.replace(pcfg, remat=False), pp,
                               bt)
    assert torch.equal(on[0], off[0])
    for a, b in zip(model._leaves(on[2]), model._leaves(off[2])):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)
    # "dots" saves the 2-D products instead of recomputing them: the
    # same loss and the same gradients as "full"
    dots = steps.value_and_grad(dataclasses.replace(
        pcfg, remat=True, remat_policy="dots"), pp, bt)
    assert torch.equal(dots[0], on[0])
    for a, b in zip(model._leaves(dots[2]), model._leaves(on[2])):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


DOTS = dict(attn_impl="dense", remat=True, remat_policy="dots")


@functools.lru_cache(maxsize=None)
def jax_dots_grads(arch):
    """The JAX package's loss, parts and gradients under remat "dots" at
    the smoke config, weights seed 1, batch seed 2."""
    jcfg, _ = configs(arch, **DOTS)
    jp = jax_model.init_params(jcfg, jax.random.key(1))
    bt = lm_batch(jcfg.vocab_size, seed=2)
    (wl, wparts), wg = jax.jit(jax.value_and_grad(
        functools.partial(jax_steps.loss_fn, jcfg), has_aux=True))(
        jp, jax.tree.map(jnp.asarray, bt))
    return wl, wparts, wg


class _OpCount(TorchDispatchMode):
    def __init__(self, ops):
        super().__init__()
        self.ops, self.n = ops, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in self.ops
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("impl", ["dense", "kernel"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m"])
def test_remat_dots_matches_jax_dots(arch, impl):
    """remat_policy="dots" against the JAX package's
    (dots_with_no_batch_dims_saveable) with carried weights, dense and
    MoE; equal to the port's "full"; and the backward really reuses the
    forward's 2-D products: under "dots" it runs fewer ``aten.mm`` than
    under "full", which recomputes them, while the batched products
    (``aten.bmm``: the experts, the dense attention) are recomputed under
    both."""
    jcfg, pcfg = configs(arch, **DOTS)
    pcfg = dataclasses.replace(pcfg, attn_impl=impl)
    _, pp = carried(jcfg, pcfg, seed=1)
    bt = lm_batch(jcfg.vocab_size, seed=2)
    wl, wparts, wg = jax_dots_grads(arch)
    tb = {k: T(v) for k, v in bt.items()}
    mm = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
    bmm = (torch.ops.aten.bmm.default,)
    got, counts = {}, {}
    for policy in ("dots", "full"):
        cfg = dataclasses.replace(pcfg, remat_policy=policy)
        tp = steps._trainable(pp)
        loss, parts = steps.loss_fn(cfg, tp, tb)
        with _OpCount(mm) as n_mm, _OpCount(bmm) as n_bmm:
            loss.backward()
        got[policy] = (loss.detach(), parts, steps._grads(tp))
        counts[policy] = (n_mm.n, n_bmm.n)
    loss, parts, grads = got["dots"]
    np.testing.assert_allclose(N(loss), np.asarray(wl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(N(parts["moe_aux"]),
                               np.asarray(wparts["moe_aux"]), rtol=LOSS_RTOL)
    assert_grads_close(pcfg, grads, wg)
    assert torch.equal(loss, got["full"][0])
    for a, b in zip(model._leaves(grads), model._leaves(got["full"][2])):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)
    assert counts["dots"][0] < counts["full"][0]
    assert counts["dots"][1] == counts["full"][1]


def test_train_step_two_microbatches_matches_jax():
    jcfg, pcfg = configs("llama3-8b")
    jp, pp = carried(jcfg, pcfg, seed=2)
    from repro.optim import adamw_init as jax_init
    jopt = jax_init(jp)
    popt = adamw.adamw_init(pp)
    kw = dict(num_microbatches=2, peak_lr=1e-2, warmup_steps=1,
              total_steps=10)
    jstep = jax.jit(jax_steps.make_train_step(jcfg, **kw))
    pstep = steps.make_train_step(pcfg, **kw)
    for i in range(2):
        bt = lm_batch(jcfg.vocab_size, b=4, seed=10 + i)
        jp, jopt, jm = jstep(jp, jopt, jax.tree.map(jnp.asarray, bt))
        pp, popt, pm = pstep(pp, popt, {k: T(v) for k, v in bt.items()})
        assert set(pm) == set(jm) == {"loss", "lr", "grad_norm"}
        for key in ("loss", "lr", "grad_norm"):
            np.testing.assert_allclose(N(pm[key]), np.asarray(jm[key]),
                                       rtol=TRAIN_RTOL, err_msg=key)
    # one microbatch: the loss's parts come along
    _, _, pm = steps.make_train_step(pcfg)(pp, popt, {
        k: T(v) for k, v in lm_batch(jcfg.vocab_size, seed=9).items()})
    assert {"ce", "moe_aux"} <= set(pm)


def test_train_matches_jax(monkeypatch):
    """``launch.train.train`` for 3 steps from the JAX driver's own
    initial weights: the same losses."""
    from repro.launch import train as jax_train
    from repro_torch.launch import train as port_train
    jcfg, pcfg = configs("qwen3-1.7b")
    monkeypatch.setattr(jax_train, "get_smoke_config", lambda a: jcfg)
    monkeypatch.setattr(port_train, "get_smoke_config", lambda a: pcfg)
    want = jax_train.train("qwen3-1.7b", steps=3, batch=2, seq=16,
                           log_every=100)
    _, pp = carried(jcfg, pcfg, seed=0)
    seen = []
    got = port_train.train("qwen3-1.7b", steps=3, batch=2, seq=16,
                           log_every=100, device="cpu", params=pp,
                           on_step=lambda s, m, t: seen.append(
                               (s, float(m["loss"]))))
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=TRAIN_RTOL)
    assert seen == list(enumerate(got["losses"]))


@pytest.mark.parametrize("arch", DENSE_ARCHS + NEW_ARCHS)
@pytest.mark.parametrize("kind,batch,seq", [("train", 256, 4096),
                                            ("prefill", 32, 32768),
                                            ("decode", 128, 32768)])
def test_model_flops_match_jax(arch, kind, batch, seq):
    from repro.models.flops import model_flops as jax_flops
    assert flops.model_flops(get_config(arch), kind, batch, seq) == \
        jax_flops(jax_config(arch), kind, batch, seq)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "hubert-xlarge",
                                  "qwen2-vl-2b"])
def test_batch_at_matches_jax(arch):
    from repro.data.pipeline import batch_at as jax_batch_at
    from repro_torch.data.pipeline import batch_at
    for step in (0, 3):
        want = jax_batch_at(jax_smoke(arch), step, batch=2, seq=16, seed=1)
        got = batch_at(get_smoke_config(arch), step, batch=2, seq=16,
                       seed=1, device="cpu")
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == (torch.int32 if want[k].dtype == jnp.int32
                                    else torch.float32)
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))


# ---------------------------------------------------------------------------
# the plain flash-attention backward
# ---------------------------------------------------------------------------

BWD_CASES = [
    # causal, window, softcap, g, sq, sk
    (True, None, None, 2, 24, 24),
    (True, 5, None, 2, 24, 24),
    (False, None, 20.0, 1, 20, 28),
    (True, 7, 30.0, 4, 24, 24),
    (True, None, None, 2, 12, 30),        # Sq < Sk
    (False, 4, None, 2, 30, 10),          # rows 13.. have no live key
]


def bwd_inputs(g, sq, sk, seed, d=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2 * g, sq, d)).astype(np.float32),
            rng.normal(size=(2, sk, d)).astype(np.float32),
            rng.normal(size=(2, sk, d)).astype(np.float32),
            rng.normal(size=(2 * g, sq, d)).astype(np.float32))


def jax_vjp(fn, q, k, v, do):
    """The cotangents of q, k, v under ``fn``, jitted."""
    return jax.jit(lambda *a: jax.vjp(fn, *a[:3])[1](a[3]))(q, k, v, do)


def plain_bwd(q, k, v, do, **kw):
    q, k, v, do = map(T, (q, k, v, do))
    o = ref.flash_attention(q, k, v, **kw)
    return ref.flash_attention_bwd(q, k, v, o, do, **kw)


@pytest.mark.parametrize("causal,window,softcap,g,sq,sk", BWD_CASES)
def test_flash_bwd_matches_jax_vjp(causal, window, softcap, g, sq, sk):
    """``ref.flash_attention_bwd`` against jax.vjp of the JAX package's
    attention oracle (``kernels/ref.flash_attention``, masked scores
    set to NEG_INF) and of ``models.attention.dense_attention``. The
    latter adds NEG_INF as a bias instead, which passes a gradient to
    the scores of a row with no live key through the rounded constant:
    its dV is compared on every case, its dQ and dK where every row has
    a live key."""
    q, k, v, do = bwd_inputs(g, sq, sk, seed=sq + sk + g)
    kw = dict(g=g, causal=causal, window=window, softcap=softcap)
    got = plain_bwd(q, k, v, do, **kw)
    for a, w in zip(got, jax_vjp(
            lambda a, b, c: jax_ref.flash_attention(a, b, c, **kw),
            *map(jnp.asarray, (q, k, v, do)))):
        np.testing.assert_allclose(N(a), np.asarray(w), atol=ATT_TOL,
                                   rtol=ATT_TOL)

    def model_layout(x, h):
        return jnp.asarray(x.reshape(2, h, -1, 16).transpose(0, 2, 1, 3))

    dq, dk, dv = (np.asarray(x).transpose(0, 2, 1, 3).reshape(-1, x.shape[1],
                                                              16)
                  for x in jax_vjp(
                      lambda a, b, c: jax_attn.dense_attention(
                          a, b, c, causal=causal, window=window,
                          logit_softcap=softcap),
                      model_layout(q, g), model_layout(k, 1),
                      model_layout(v, 1), model_layout(do, g)))
    every_row_live = window is None or sq <= sk - 1 + window
    pairs = ((got[2], dv),) + (((got[0], dq), (got[1], dk))
                               if every_row_live else ())
    for a, w in pairs:
        np.testing.assert_allclose(N(a), w, atol=ATT_TOL, rtol=ATT_TOL)


@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, 50.0),                   # gemma2-9b's kind
    (True, 16, None),                     # gemma3-12b's local layers
])
def test_flash_bwd_matches_jax_vjp_head_dim_256(causal, window, softcap):
    """``ref.flash_attention_bwd``, the card's parity target for the
    tensor-core backward at head_dim 256, against jax.vjp of the JAX
    package's oracle at that width and its default scale 256^-1/2, g = 2,
    48 positions (the window of 16 cuts them)."""
    q, k, v, do = bwd_inputs(2, 48, 48, seed=256 + (window or 0), d=256)
    kw = dict(g=2, causal=causal, window=window, softcap=softcap)
    got = plain_bwd(q, k, v, do, **kw)
    for a, w in zip(got, jax_vjp(
            lambda a, b, c: jax_ref.flash_attention(a, b, c, **kw),
            *map(jnp.asarray, (q, k, v, do)))):
        np.testing.assert_allclose(N(a), np.asarray(w), atol=ATT_TOL,
                                   rtol=ATT_TOL)


@pytest.mark.parametrize("causal,window,softcap,g,sq,sk", BWD_CASES)
def test_flash_bwd_matches_torch_autograd(causal, window, softcap, g, sq,
                                          sk):
    """``ref.flash_attention_bwd`` against torch autograd of
    ``ref.flash_attention``; and the autograd function through
    ``ops.flash_attention`` (the model's layout) on the CPU."""
    q, k, v, do = bwd_inputs(g, sq, sk, seed=sq * sk + g)
    kw = dict(g=g, causal=causal, window=window, softcap=softcap)
    got = plain_bwd(q, k, v, do, **kw)
    qt, kt, vt = (T(x).requires_grad_() for x in (q, k, v))
    want = torch.autograd.grad(ref.flash_attention(qt, kt, vt, **kw),
                               (qt, kt, vt), T(do))
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=ATT_TOL, rtol=ATT_TOL)

    def model_layout(x, h):
        return T(x).reshape(2, h, -1, 16).transpose(1, 2) \
            .contiguous().requires_grad_()

    qm, km, vm = model_layout(q, g), model_layout(k, 1), model_layout(v, 1)
    out = ops.flash_attention(qm, km, vm, causal=causal, window=window,
                              logit_softcap=softcap)
    assert out.grad_fn is not None
    back = torch.autograd.grad(out, (qm, km, vm),
                               T(do).reshape(2, g, -1, 16).transpose(1, 2))
    for a, w in zip(back, want):
        torch.testing.assert_close(a.transpose(1, 2).reshape(w.shape), w,
                                   atol=ATT_TOL, rtol=ATT_TOL)


def test_flash_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention_bwd_bhsd(q, q, q, q, q,
                                                 torch.zeros(2, 8), g=1)


@pytest.mark.parametrize("causal,window,softcap,g,sq,sk", BWD_CASES)
def test_flash_bwd_given_lse_matches_recomputed(causal, window, softcap, g,
                                                sq, sk):
    """``ref.flash_attention_bwd`` handed the forward's L equals the same
    call that recomputes L (1e-6), and still equals jax.vjp of the JAX
    package's attention oracle."""
    q, k, v, do = bwd_inputs(g, sq, sk, seed=sq + 2 * sk + g)
    kw = dict(g=g, causal=causal, window=window, softcap=softcap)
    qt, kt, vt, dot = map(T, (q, k, v, do))
    o, lse = ref.flash_attention(qt, kt, vt, return_lse=True, **kw)
    got = ref.flash_attention_bwd(qt, kt, vt, o, dot, lse, **kw)
    again = ref.flash_attention_bwd(qt, kt, vt, o, dot, **kw)
    for a, w in zip(got, again):
        torch.testing.assert_close(a, w, atol=1e-6, rtol=1e-6)
    for a, w in zip(got, jax_vjp(
            lambda a, b, c: jax_ref.flash_attention(a, b, c, **kw),
            *map(jnp.asarray, (q, k, v, do)))):
        np.testing.assert_allclose(N(a), np.asarray(w), atol=ATT_TOL,
                                   rtol=ATT_TOL)


@pytest.mark.parametrize("causal,window,softcap,g,sq,sk", BWD_CASES)
def test_flash_autograd_saves_lse_on_cpu(causal, window, softcap, g, sq,
                                         sk):
    """``FlashAttention`` on the CPU: where a gradient can be asked for,
    the forward saves the plain L beside q, k, v and O, and the backward
    gives the gradients of the plain backward with L recomputed; with
    grad off ``ops.flash_attention`` asks it for no L."""
    q, k, v, do = bwd_inputs(g, sq, sk, seed=3 * sq + sk + g)
    kw = dict(g=g, causal=causal, window=window, softcap=softcap)

    def model_layout(x, h):
        return T(x).reshape(2, h, -1, 16).requires_grad_()

    qm, km, vm = model_layout(q, g), model_layout(k, 1), model_layout(v, 1)
    out = flash_attention.FlashAttention.apply(qm, km, vm, g, causal, window,
                                               softcap, None)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5
    o, lse = ref.flash_attention(T(q), T(k), T(v), return_lse=True, **kw)
    assert torch.equal(saved[4], lse.reshape(2, g, sq))
    assert torch.equal(saved[3].reshape(o.shape), o)
    back = torch.autograd.grad(out, (qm, km, vm), T(do).reshape(out.shape))
    want = ref.flash_attention_bwd(T(q), T(k), T(v), o, T(do), **kw)
    for a, w in zip(back, want):
        torch.testing.assert_close(a.reshape(w.shape), w, atol=1e-6,
                                   rtol=1e-6)
    asked = []
    real = ref.flash_attention

    def spy(*a, **k):
        asked.append(k.get("return_lse", False))
        return real(*a, **k)

    ref.flash_attention = spy
    try:
        with torch.no_grad():
            ops.flash_attention(qm.transpose(1, 2), km.transpose(1, 2),
                                vm.transpose(1, 2), causal=causal,
                                window=window, logit_softcap=softcap)
    finally:
        ref.flash_attention = real
    assert asked == [False]


# ---------------------------------------------------------------------------
# the corpus filter through the port's compiler, and the device default
# ---------------------------------------------------------------------------

def test_corpus_filter_gets_datascan_pushdown():
    from repro_torch.core import compile_query
    from repro_torch.core.algebra import DataScan, walk
    from repro_torch.data.pipeline import corpus_query
    plan = compile_query(corpus_query(0.5))
    scans = [o for o in walk(plan) if isinstance(o, DataScan)]
    assert len(scans) == 1
    assert scans[0].path == ("docCollection", "doc")


def test_corpus_database_matches_jax():
    from repro.data.pipeline import build_corpus_database as jax_build
    from repro_torch.core import xdm
    from repro_torch.data.pipeline import build_corpus_database
    from test_torch_state import assert_same_database
    assert_same_database(build_corpus_database(num_docs=64),
                         xdm.database_from_arrays(*xdm.database_to_arrays(
                             jax_build(num_docs=64))))


def test_corpus_filter_matches_saxon():
    from repro_torch.core import Executor, compile_query
    from repro_torch.core.baselines import SaxonLike
    from repro_torch.data.pipeline import build_corpus_database, corpus_query
    db = build_corpus_database(num_docs=64, num_partitions=4)
    q = corpus_query(0.5)
    got = sorted(map(str, Executor(db, device="cpu")
                     .run(compile_query(q)).rows()))
    want = sorted(map(str, SaxonLike(db).run_rows(q)))
    assert got == want and got       # non-degenerate


def test_corpus_stats_two_step():
    from repro_torch.core import Executor, compile_query
    from repro_torch.core.algebra import Aggregate, walk
    from repro_torch.core.baselines import SaxonLike
    from repro_torch.data.pipeline import (build_corpus_database,
                                           corpus_stats_query)
    db = build_corpus_database(num_docs=64, num_partitions=4)
    plan = compile_query(corpus_stats_query())
    agg = [o for o in walk(plan) if isinstance(o, Aggregate)][0]
    assert (agg.local_fn, agg.global_fn) == ("sum", "sum")
    got = Executor(db, device="cpu").run(plan).scalar()
    want = SaxonLike(db).run(corpus_stats_query())[0]
    assert got == pytest.approx(want, rel=1e-4)


def test_train_entry_points_default_to_cuda(monkeypatch):
    """``launch.train.train`` and the batches run on the GPU unless the
    caller asks for the CPU."""
    from repro_torch.data.pipeline import batch_at
    from repro_torch.launch.train import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train("qwen3-1.7b", steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch_at(get_smoke_config("qwen3-1.7b"), 0, batch=1, seq=4)
    out = train("qwen3-1.7b", steps=1, batch=2, seq=8, device="cpu")
    assert next(model._leaves(out["params"])).device.type == "cpu"
