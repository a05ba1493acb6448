"""The port's MoE layer (``repro_torch.models.moe``) and the MoE models
against the JAX package on the CPU, at the smoke size of the configs
(d_model 64, 4 experts, d_ff_expert 32), with seeded numpy inputs and
the JAX weights carried across by ``convert.params_from_numpy``.

Tolerances, float32: the layer's outputs within 1e-5 and its aux loss
within 1e-6 (the combine sums each token's k results in another order
than the reference's scatter-add), expert ids equal, gradients within
1e-4 of each leaf's largest |g| (top-1's gate is g / g, whose gradient
is float32 cancellation noise beside the aux loss's); the whole models' logits and hidden
states within 1e-4, the served tokens equal, the training gradients as
``tests/test_torch_train.py`` holds them.

bfloat16 is held sublayer by sublayer (``check_sublayers_bf16``): each
layer's mixer and MLP take the JAX run's own bf16 input, and their
outputs agree within 4 bf16 ulps of their largest |value| (each adds
one to three bf16 roundings the two frameworks place differently:
llama4's top-1 combine and shared expert differ by 2 ulps). Whole-model
bf16 logits are compared only without MoE (``tests/test_torch_ssm.py``,
within the dense bf16 test's 3e-2): the
two frameworks round bf16 at other places (XLA fuses elementwise chains
in float32), and a token whose k-th and (k+1)-th router probabilities
are that close takes another expert in one framework than in the other
and moves its logits by far more (the smoke jamba's by 0.17). Given the
same bf16 input, the routers agree expert for expert. The whole-model
checks are shared with ``tests/test_torch_ssm.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro.models import moe as jax_moe
from repro.models import ssm as jax_ssm
from repro.models import steps as jax_steps
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.models import convert, layers, model, moe, ssm, steps

OUT_TOL = 1e-5
AUX_TOL = 1e-6
GRAD_TOL = 1e-4            # of each leaf's largest |g|
TOL = 1e-4
BF16_ATOL = 3e-2
MOE_ARCHS = ["granite-moe-1b-a400m", "llama4-scout-17b-a16e"]


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def N(t):
    return t.detach().float().numpy()


def configs(arch, **over):
    """(JAX config, port config) of one smoke arch, the same overrides."""
    return (dataclasses.replace(jax_smoke(arch), **over),
            dataclasses.replace(get_smoke_config(arch), **over))


@functools.cache
def _jax_init(arch, seed):
    """The smoke model's JAX weights, made once per (arch, seed): they do
    not depend on the compute dtype."""
    return jax.jit(functools.partial(jax_model.init_params,
                                     jax_smoke(arch)))(jax.random.key(seed))


def carried(jcfg, pcfg, seed=0):
    jp = _jax_init(jcfg.name, seed)
    return jp, convert.params_from_numpy(pcfg, jax.tree.map(np.asarray, jp),
                                         device="cpu")


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

# (top_k, shared experts, capacity factor): granite's top-2, llama4's
# top-1 with a shared expert, and a capacity small enough to drop
LAYER_CASES = [(2, 0, 1.25), (1, 1, 1.25), (2, 0, 0.5), (1, 0, 0.5)]


def layer_inputs(top_k, shared, seed=0, t=40, d=16, e=4, f=24):
    key = jax.random.key(seed)
    jp = jax_moe.moe_init(key, d, f, e, shared)
    x = np.random.default_rng(seed).normal(size=(t, d)).astype(np.float32)
    return jp, x


def port_params(jp):
    return jax.tree.map(lambda a: T(np.asarray(a)), jp)


@pytest.mark.parametrize("top_k,shared,cf", LAYER_CASES)
def test_moe_apply_matches_jax(top_k, shared, cf):
    jp, x = layer_inputs(top_k, shared, seed=top_k + 3 * shared)
    want, waux = jax.jit(functools.partial(
        jax_moe.moe_apply, top_k=top_k, capacity_factor=cf))(
        jp, jnp.asarray(x))
    pp = port_params(jp)
    got, aux = moe.moe_apply(pp, T(x), top_k=top_k, capacity_factor=cf)
    np.testing.assert_allclose(N(got), np.asarray(want), atol=OUT_TOL,
                               rtol=OUT_TOL)
    np.testing.assert_allclose(N(aux), np.asarray(waux), atol=AUX_TOL,
                               rtol=AUX_TOL)
    # the same experts, in the same slot order
    logits = jnp.asarray(x) @ jp["router"]
    _, wids = jax.lax.top_k(jax.nn.softmax(logits, -1), top_k)
    r = moe.route(pp, T(x), top_k=top_k, capacity_factor=cf)
    np.testing.assert_array_equal(r["expert_ids"].numpy(), np.asarray(wids))
    kept = int((r["pos"] < r["cap"]).sum())
    if cf < 1:
        assert kept < x.shape[0] * top_k          # some assignments drop
    else:
        assert kept == x.shape[0] * top_k


@pytest.mark.parametrize("top_k,shared,cf", LAYER_CASES)
def test_moe_grads_match_jax_vjp(top_k, shared, cf):
    """The gradients of x and of every MoE leaf against jax.vjp, for a
    seeded cotangent of the output and a weight on the aux loss."""
    jp, x = layer_inputs(top_k, shared, seed=10 + top_k + 3 * shared)
    dy = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)

    def jfn(p, xx):
        y, aux = jax_moe.moe_apply(p, xx, top_k=top_k, capacity_factor=cf)
        return jnp.sum(y * dy) + 0.7 * aux

    wgp, wgx = jax.jit(jax.grad(jfn, argnums=(0, 1)))(jp, jnp.asarray(x))
    pp = jax.tree.map(lambda a: T(np.asarray(a)).requires_grad_(), jp)
    xt = T(x).requires_grad_()
    y, aux = moe.moe_apply(pp, xt, top_k=top_k, capacity_factor=cf)
    (torch.sum(y * T(dy)) + 0.7 * aux).backward()
    pairs = [(xt.grad, wgx)] + list(zip(
        [t.grad for t in jax.tree.leaves(pp)], jax.tree.leaves(wgp)))
    for g, w in pairs:
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(N(g) - w).max()) <= GRAD_TOL * scale
    # the router gets a gradient through the gates and the aux loss
    assert float(pp["router"].grad.abs().max()) > 0


@pytest.mark.parametrize("e,k", [(4, 1), (4, 2), (32, 8), (16, 1), (16, 2)])
def test_expert_capacity_matches_jax(e, k):
    for t in (1, 2, 7, 8, 9, 40, 255, 4096, 16384):
        for cf in (0.5, 1.0, 1.25, 2.0):
            assert moe.expert_capacity(t, e, k, cf) == \
                jax_moe.expert_capacity(t, e, k, cf)


def test_router_ties_keep_the_lower_expert_first():
    """Equal router probabilities: lax.top_k puts the lower index first,
    and so does the port (a stable sort; ``torch.topk`` on the CPU gives
    another order, which this shows too)."""
    d, e = 8, 6
    router = np.random.default_rng(0).normal(size=(d, e)).astype(np.float32)
    router[:, 3] = router[:, 1]          # experts 1 and 3 tie everywhere
    router[:, 5] = router[:, 1]
    x = np.random.default_rng(1).normal(size=(12, d)).astype(np.float32)
    x[:4] = 0.0                          # every expert ties on these rows
    jp = {"router": jnp.asarray(router)}
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["router"], -1)
    for k in (1, 2, 3, 4):
        _, want = jax.lax.top_k(probs, k)
        r = moe.route({"router": T(router)}, T(x), top_k=k)
        np.testing.assert_array_equal(r["expert_ids"].numpy(),
                                      np.asarray(want))
    np.testing.assert_array_equal(r["expert_ids"][:4].numpy(),
                                  np.tile(np.arange(4), (4, 1)))
    flat = torch.full((1, 32), 1.0 / 32)
    assert torch.topk(flat, 8).indices.tolist() != [list(range(8))]


def test_moe_repartition_ranks_and_drops():
    """``route``'s sorted ranks: each expert's assignments in token
    order, ranks 0..count-1, the ones past ``cap`` sent to the spare
    row."""
    jp, x = layer_inputs(2, 0, seed=7, t=64)
    r = moe.route(port_params(jp), T(x), top_k=2, capacity_factor=0.5)
    flat = r["expert_ids"].reshape(-1)
    se = flat[r["order"]]
    cap, rows = r["cap"], 4 * r["cap"]
    for ex in range(4):
        idx = (se == ex).nonzero()[:, 0]
        assert r["pos"][idx].tolist() == list(range(len(idx)))
        assert bool((r["order"][idx].diff() > 0).all())   # token order
        kept = r["pos"][idx] < cap
        assert r["dest"][idx][kept].tolist() == \
            [ex * cap + p for p in range(int(kept.sum()))]
        assert bool((r["dest"][idx][~kept] == rows).all())


# ---------------------------------------------------------------------------
# the whole models (shared with tests/test_torch_ssm.py)
# ---------------------------------------------------------------------------

def prompts(vocab, b=3, s=16, seed=0):
    return np.random.default_rng(seed).integers(1, vocab, (b, s)) \
        .astype(np.int32)


def grown_jax_caches(jcfg, caches, b, s, max_len):
    """The reference serve's ``grow``: attention caches into max_len
    slots, every other cache as it is."""
    grown = jax_model.init_cache(jcfg, b, max_len)
    out = []
    for dst, src in zip(grown, caches):
        if "k" in src:
            out.append({k: dst[k].at[:, :, :s].set(src[k]) for k in dst})
        else:
            out.append(src)
    return tuple(out)


def check_prefill_and_decode(arch, dtype="float32", tol=TOL, atol=TOL,
                             batch=None, **over):
    """Prefill's hidden states, logits and caches, then four decode
    steps from the grown caches, against the JAX package. ``batch``: the
    prefill's numpy inputs (default: ``prompts``); ``over``: config
    fields of the port's side only."""
    jcfg, pcfg = configs(arch, compute_dtype=dtype)
    pcfg = dataclasses.replace(pcfg, **over)
    jp, pp = carried(jcfg, pcfg, seed=1)
    if batch is None:
        batch = {"tokens": prompts(jcfg.vocab_size)}
    jh, jcaches = jax.jit(functools.partial(jax_model.prefill, jcfg))(
        jp, jax.tree.map(jnp.asarray, batch))
    b, s = jh.shape[:2]
    cp = model.compute_params(pcfg, pp)
    ph, pcaches = model.prefill(pcfg, cp, {k: T(v) for k, v in batch.items()})
    jl = jax_model.logits_from_hidden(jcfg, jp, jh)
    pl = model.logits_from_hidden(pcfg, cp, ph)
    np.testing.assert_allclose(N(pl), np.asarray(jl, np.float32), atol=atol,
                               rtol=tol)
    if dtype == "float32":
        np.testing.assert_allclose(N(ph), np.asarray(jh), atol=tol, rtol=tol)
        for jc, pc in zip(jcaches, convert.stack_layers(pcfg, pcaches)):
            assert set(jc) == set(pc)
            for key in jc:
                assert pc[key].dtype == getattr(torch, str(jc[key].dtype))
                np.testing.assert_allclose(N(pc[key]), np.asarray(jc[key]),
                                           atol=tol, rtol=tol)
    max_len = s + 4
    jc = grown_jax_caches(jcfg, jcaches, b, s, max_len)
    pc = model.init_cache(pcfg, b, max_len, device="cpu")
    for dst, src in zip(pc, pcaches):
        if "k" in src:
            dst["k"][:, :s] = src["k"]
            dst["v"][:, :s] = src["v"]
        else:
            dst.update(src)
    kv_len = np.asarray([9, 13, s], np.int32)    # b == 3
    feed = prompts(jcfg.vocab_size, b, 4, seed=3)
    jdec = jax.jit(functools.partial(jax_model.decode_step_hidden, jcfg))
    for t in range(4):
        kv_len = kv_len + 1
        jh, jc = jdec(jp, jc, jnp.asarray(feed[:, t:t + 1]),
                      jnp.asarray(kv_len))
        ph, pc = model.decode_step_hidden(
            pcfg, cp, pc, torch.from_numpy(feed[:, t:t + 1]),
            torch.from_numpy(kv_len))
        np.testing.assert_allclose(
            N(model.logits_from_hidden(pcfg, cp, ph)),
            np.asarray(jax_model.logits_from_hidden(jcfg, jp, jh),
                       np.float32), atol=atol, rtol=tol)
    if dtype == "float32":
        for jcc, pcc in zip(jc, convert.stack_layers(pcfg, pc)):
            for key in jcc:
                np.testing.assert_allclose(N(pcc[key]), np.asarray(jcc[key]),
                                           atol=tol, rtol=tol)


def _bf16_close(got, want, what):
    """Within 4 bf16 ulps of the largest |want| (8 significant bits)."""
    want = np.asarray(want, np.float32)
    top = float(np.abs(want).max())
    tol = 4 * 2.0 ** (np.floor(np.log2(max(top, 2.0 ** -60))) - 7)
    err = float(np.abs(N(got) - want).max())
    assert err <= tol, (what, err, tol)


def check_sublayers_bf16(arch, batch=None):
    """The smoke model in its bf16 compute, layer by layer on the JAX
    run's hidden states: each layer's mixer sublayer (norm, attention or
    Mamba-2, residual) from the JAX input, and its MLP (dense or MoE)
    from the JAX run's normalised input, against the JAX package's own
    functions on the weights ``_cast_blocks`` gives; the MoE router's
    expert ids equal. ``batch``: numpy inputs (default: ``prompts``)."""
    jcfg, pcfg = configs(arch)
    assert pcfg.cdtype == torch.bfloat16 and not pcfg.use_post_norm
    jp, pp = carried(jcfg, pcfg, seed=1)
    if batch is None:
        batch = {"tokens": prompts(jcfg.vocab_size)}
    h, positions = jax_model._embed_inputs(jcfg, jp, jax.tree.map(
        jnp.asarray, batch))
    blocks = jax_model._cast_blocks(jcfg, jp)
    layers_c = model.compute_params(pcfg, pp)["layers"]
    eps = jcfg.norm_eps

    def jax_mixer(spec, p, h):
        x = jax_layers.rmsnorm(p["ln_mixer"], h, eps)
        if spec.mixer.startswith("attn"):
            out, _ = jax_model._attn_block(jcfg, spec, p["attn"], x,
                                           positions)
        else:
            out = jax_ssm.mamba2_forward(
                p["mamba"], x, state=jcfg.ssm_state, conv=jcfg.ssm_conv,
                expand=jcfg.ssm_expand, head_dim=jcfg.ssm_head_dim,
                chunk=jcfg.ssm_chunk, norm_eps=eps)
        h = h + out
        return h, jax_layers.rmsnorm(p["ln_mlp"], h, eps)

    def jax_mlp(spec, p, x):
        if spec.mlp == "dense":
            return jax_layers.mlp(p["mlp"], x, act=jcfg.act), None
        b, s, d = x.shape
        out, _ = jax_moe.moe_apply(p["moe"], x.reshape(b * s, d),
                                   top_k=jcfg.top_k,
                                   capacity_factor=jcfg.capacity_factor,
                                   act=jcfg.act)
        xf = x.reshape(b * s, d).astype(jnp.float32)
        _, ids = jax.lax.top_k(jax.nn.softmax(xf @ p["moe"]["router"], -1),
                               jcfg.top_k)
        return out.reshape(b, s, d), ids

    jitted = {}
    for i, pl in enumerate(layers_c):
        spec = jcfg.layer_spec(i)
        if spec not in jitted:
            jitted[spec] = (jax.jit(functools.partial(jax_mixer, spec)),
                            jax.jit(functools.partial(jax_mlp, spec)))
        jmix, jmlp = jitted[spec]
        jl = jax.tree.map(lambda a: a[i // jcfg.period],
                          blocks[i % jcfg.period])
        h1, x2 = jmix(jl, h)
        ht = T(np.asarray(h.astype(jnp.float32))).to(torch.bfloat16)
        ph1 = model._apply_block_with_cache(
            pcfg, dataclasses.replace(spec, mlp="none"), pl, ht,
            T(np.asarray(positions)))[0]
        _bf16_close(ph1, h1, f"layer {i} mixer")
        _bf16_close(layers.rmsnorm(pl["ln_mlp"], T(np.asarray(
            h1.astype(jnp.float32))).to(torch.bfloat16), eps), x2,
            f"layer {i} ln_mlp")
        out, ids = jmlp(jl, x2)
        x2t = T(np.asarray(x2.astype(jnp.float32))).to(torch.bfloat16)
        if spec.mlp == "dense":
            pout = layers.mlp(pl["mlp"], x2t, act=pcfg.act)
        else:
            flat = x2t.reshape(-1, x2t.shape[-1])
            pout, _ = moe.moe_apply(pl["moe"], flat, top_k=pcfg.top_k,
                                    capacity_factor=pcfg.capacity_factor,
                                    act=pcfg.act)
            pout = pout.reshape(x2t.shape)
            r = moe.route(pl["moe"], flat, top_k=pcfg.top_k)
            np.testing.assert_array_equal(r["expert_ids"].numpy(),
                                          np.asarray(ids))
        _bf16_close(pout, out, f"layer {i} {spec.mlp}")
        h = h1 + out


def check_serve_tokens(arch, monkeypatch):
    """``serve_batch`` against the JAX ``launch.serve`` in float32: the same
    generated tokens."""
    from repro.launch import serve as jax_serve
    jcfg, pcfg = configs(arch, compute_dtype="float32")
    monkeypatch.setattr(jax_serve, "get_smoke_config", lambda a: jcfg)
    jp, pp = carried(jcfg, pcfg, seed=1)
    # launch.serve's own init(key(1)), made once
    monkeypatch.setattr(jax_serve.model_lib, "init_params",
                        lambda cfg, key: jp)
    kw = dict(num_requests=3, prompt_len=16, gen_len=5, seed=1)
    want = jax_serve.serve_batch(arch, **kw)
    got = serve.serve_batch(arch, device="cpu", params=pp,
                            overrides={"compute_dtype": "float32"}, **kw)
    np.testing.assert_array_equal(got["generated"], want["generated"])


def lm_batch(vocab, b=2, s=16, seed=0):
    toks = np.random.default_rng(seed).integers(1, vocab, (b, s + 1)) \
        .astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def check_value_and_grad(arch, monkeypatch=None, **over):
    """``steps.value_and_grad`` against jax.value_and_grad of the JAX
    loss_fn in float32: loss, ce and moe_aux rtol 1e-5, each leaf within
    1e-4 of its largest |g| (``test_torch_train.assert_grads_close``).
    Returns the port's parts."""
    from test_torch_train import assert_grads_close
    jcfg, pcfg = configs(arch, compute_dtype="float32", **over)
    jp, pp = carried(jcfg, pcfg, seed=1)
    bt = lm_batch(jcfg.vocab_size, seed=2)
    (wl, wparts), wg = jax.jit(jax.value_and_grad(
        functools.partial(jax_steps.loss_fn, jcfg), has_aux=True))(
        jp, jax.tree.map(jnp.asarray, bt))
    loss, parts, grads = steps.value_and_grad(
        pcfg, pp, {k: T(v) for k, v in bt.items()})
    np.testing.assert_allclose(N(loss), np.asarray(wl), rtol=1e-5)
    for key in ("ce", "moe_aux"):
        np.testing.assert_allclose(N(parts[key]), np.asarray(wparts[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    assert_grads_close(pcfg, grads, wg)
    return parts


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_model_prefill_and_decode_match_jax_f32(arch):
    check_prefill_and_decode(arch)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_model_sublayers_bf16(arch):
    check_sublayers_bf16(arch)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_model_serve_tokens_match_jax_f32(arch, monkeypatch):
    check_serve_tokens(arch, monkeypatch)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_model_value_and_grad_matches_jax(arch):
    parts = check_value_and_grad(arch)
    assert float(parts["moe_aux"]) > 0


def test_moe_aux_is_differentiable_and_weighted():
    """The loss adds 0.01 x the summed aux loss, and the router's
    gradient moves with the aux weight."""
    _, pcfg = configs("granite-moe-1b-a400m", compute_dtype="float32")
    pp = model.init_params(pcfg, 3, "cpu")
    bt = {k: T(v) for k, v in lm_batch(pcfg.vocab_size, seed=4).items()}
    l0, p0, g0 = steps.value_and_grad(pcfg, pp, bt, aux_weight=0.0)
    l1, p1, g1 = steps.value_and_grad(pcfg, pp, bt, aux_weight=1.0)
    torch.testing.assert_close(l0, p0["ce"])
    torch.testing.assert_close(l1, p1["ce"] + p1["moe_aux"])
    r0 = g0["layers"][0]["moe"]["router"]
    r1 = g1["layers"][0]["moe"]["router"]
    assert float((r1 - r0).abs().max()) > 1e-6
