"""The port's Mamba-2 mixer (``repro_torch.models.ssm``), the Mamba-2 and
hybrid models, and the compute-dtype cast of the layer weights, against
the JAX package on the CPU at the smoke size of the configs (d_model 64,
SSD heads of 16, state 16, chunk 8), with seeded numpy inputs and the
JAX weights carried across by ``convert.params_from_numpy``.

Tolerances, float32: the mixer's pieces within 1e-5 (another summation
order in the chunk products), their gradients within 1e-4 of each
leaf's largest |g|; the prefill against the port's own decode chain
within 1e-4 (the chunked dual form against the recurrence); the whole
models as ``tests/test_torch_moe.py`` holds them. The cast is exact:
the same bits as the reference's ``_cast_blocks``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as jax_model
from repro.models import ssm as jax_ssm
from repro_torch.models import convert, model, ssm

from test_torch_moe import (_jax_init, check_prefill_and_decode,
                            check_serve_tokens, check_sublayers_bf16,
                            check_value_and_grad, configs, carried,
                            port_params, prompts)

TOL = 1e-5
GRAD_TOL = 1e-4            # of each leaf's largest |g|
CHAIN_TOL = 1e-4
BF16_ATOL = 3e-2
SSM_ARCHS = ["mamba2-370m", "jamba-v0.1-52b"]
DIMS = dict(state=16, conv=4, expand=2, head_dim=16)


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def N(t):
    return t.detach().float().numpy()


def mixer_params(seed=0, d=32, **over):
    """JAX Mamba-2 params with non-trivial a_log, D, dt_bias, conv_b and
    norm scale (the init's are constants)."""
    dims = {**DIMS, **over}
    p = jax_ssm.mamba2_init(jax.random.key(seed), d, **dims)
    rng = np.random.default_rng(seed)
    for key in ("dt_bias", "D", "conv_b"):
        p[key] = p[key] + jnp.asarray(
            rng.normal(size=p[key].shape).astype(np.float32) * 0.3)
    p["norm"]["scale"] = jnp.asarray(
        rng.normal(size=p["norm"]["scale"].shape).astype(np.float32) * 0.1)
    return p


# ---------------------------------------------------------------------------
# the mixer's pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width,dtype", [(4, np.float32), (2, np.float32),
                                         (4, "bfloat16")])
def test_causal_conv_matches_jax(width, dtype):
    rng = np.random.default_rng(width)
    x = rng.normal(size=(2, 11, 6)).astype(np.float32)
    w = rng.normal(size=(width, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    jx = jnp.asarray(x)
    tx = T(x)
    if dtype == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    want = jax_ssm._causal_conv(jx, jnp.asarray(w), jnp.asarray(b))
    got = ssm._causal_conv(tx, T(w), T(b))
    assert got.dtype == tx.dtype
    # float32 accumulation in the same order, one rounding at the end:
    # the same bits in both dtypes
    np.testing.assert_array_equal(N(got), np.asarray(want, np.float32))


def ssd_inputs(seed, b=2, length=24, h=3, p=4, n=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, length, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, length, h)))).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 4.0, h)).astype(np.float32)
    bm = rng.normal(size=(b, length, n)).astype(np.float32)
    cm = rng.normal(size=(b, length, n)).astype(np.float32)
    state = rng.normal(size=(b, h, n, p)).astype(np.float32)
    return x, dt, a_log, bm, cm, state


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_jax(with_state):
    """Three chunks of 8, from a zero state and from a given one."""
    x, dt, a_log, bm, cm, st = ssd_inputs(3 + with_state)
    init = st if with_state else None
    wy, ws = jax_ssm.ssd_chunked(
        *map(jnp.asarray, (x, dt, a_log, bm, cm)), chunk=8,
        init_state=None if init is None else jnp.asarray(init))
    gy, gs = ssm.ssd_chunked(*map(T, (x, dt, a_log, bm, cm)), chunk=8,
                             init_state=None if init is None else T(init))
    assert gs.dtype == torch.float32
    np.testing.assert_allclose(N(gy), np.asarray(wy), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(N(gs), np.asarray(ws), atol=TOL, rtol=TOL)


def test_ssd_chunked_grads_match_jax_vjp():
    """Gradients of every input against jax.vjp: finite (the mask comes
    before the exp) and equal within GRAD_TOL of each one's largest
    |g|."""
    x, dt, a_log, bm, cm, st = ssd_inputs(7)
    rng = np.random.default_rng(8)
    dy = rng.normal(size=x.shape).astype(np.float32)
    ds = rng.normal(size=st.shape).astype(np.float32)

    def jfn(*a):
        y, s = jax_ssm.ssd_chunked(*a[:5], chunk=8, init_state=a[5])
        return jnp.sum(y * dy) + jnp.sum(s * ds)

    want = jax.jit(jax.grad(jfn, argnums=tuple(range(6))))(
        *map(jnp.asarray, (x, dt, a_log, bm, cm, st)))
    ins = [T(a).requires_grad_() for a in (x, dt, a_log, bm, cm, st)]
    y, s = ssm.ssd_chunked(*ins[:5], chunk=8, init_state=ins[5])
    (torch.sum(y * T(dy)) + torch.sum(s * T(ds))).backward()
    for t, w in zip(ins, want):
        w = np.asarray(w)
        assert bool(torch.isfinite(t.grad).all())
        err = float(np.abs(N(t.grad) - w).max())
        assert err <= GRAD_TOL * float(np.abs(w).max())


@pytest.mark.parametrize("length,chunk", [(20, 8), (7, 4)])
def test_ssd_chunked_rejects_a_ragged_length(length, chunk):
    x, dt, a_log, bm, cm, _ = ssd_inputs(0, length=length)
    with pytest.raises(ValueError, match="chunk"):
        ssm.ssd_chunked(*map(T, (x, dt, a_log, bm, cm)), chunk=chunk)
    with pytest.raises(ValueError, match="chunk"):
        jax_ssm.ssd_chunked(*map(jnp.asarray, (x, dt, a_log, bm, cm)),
                            chunk=chunk)


def test_mamba2_forward_and_decode_chain_match_jax():
    """``mamba2_forward(return_cache=True)`` over 16 tokens, then five
    ``mamba2_decode`` steps from its cache, each against JAX: outputs,
    conv tail and state."""
    jp = mixer_params(1)
    pp = port_params(jp)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 16, 32)).astype(np.float32)
    want, wc = jax.jit(functools.partial(
        jax_ssm.mamba2_forward, chunk=8, return_cache=True, **DIMS))(
        jp, jnp.asarray(x))
    got, gc = ssm.mamba2_forward(pp, T(x), chunk=8, return_cache=True,
                                 **DIMS)
    np.testing.assert_allclose(N(got), np.asarray(want), atol=TOL, rtol=TOL)
    for key in ("conv", "ssm"):
        np.testing.assert_allclose(N(gc[key]), np.asarray(wc[key]),
                                   atol=TOL, rtol=TOL)
    jdec = jax.jit(functools.partial(jax_ssm.mamba2_decode, **DIMS))
    for t in range(5):
        xt = rng.normal(size=(2, 1, 32)).astype(np.float32)
        want, wc = jdec(jp, wc, jnp.asarray(xt))
        got, gc = ssm.mamba2_decode(pp, gc, T(xt), **DIMS)
        np.testing.assert_allclose(N(got), np.asarray(want), atol=TOL,
                                   rtol=TOL)
        for key in ("conv", "ssm"):
            np.testing.assert_allclose(N(gc[key]), np.asarray(wc[key]),
                                       atol=TOL, rtol=TOL)


def test_mamba2_init_cache_matches_jax():
    want = jax_ssm.mamba2_init_cache(3, 32, dtype=jnp.bfloat16, **DIMS)
    got = ssm.mamba2_init_cache(3, 32, dtype=torch.bfloat16, **DIMS)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        assert str(got[key].dtype).split(".")[1] == str(want[key].dtype)
        assert float(got[key].abs().max()) == 0.0


def test_prefill_matches_own_decode_chain():
    """The card's gate at small size: the logits of one prefill over
    S + 8 tokens at positions S..S+7 against a prefill over the first S
    and 8 decode steps fed the next 8 tokens (float32; the chunked dual
    form against the recurrence)."""
    jcfg, pcfg = configs("mamba2-370m", compute_dtype="float32")
    _, pp = carried(jcfg, pcfg, seed=2)
    toks = prompts(pcfg.vocab_size, b=2, s=24, seed=9)
    s = 16
    h, _ = model.prefill(pcfg, pp, {"tokens": torch.from_numpy(toks)})
    want = model.logits_from_hidden(pcfg, pp, h[:, s:])
    _, caches = model.prefill(pcfg, pp, {"tokens": torch.from_numpy(
        toks[:, :s].copy())})
    kv_len = torch.full((2,), s, dtype=torch.int32)
    got = []
    for t in range(s, s + 8):
        kv_len = kv_len + 1
        hd, caches = model.decode_step_hidden(
            pcfg, pp, caches, torch.from_numpy(toks[:, t:t + 1].copy()),
            kv_len)
        got.append(model.logits_from_hidden(pcfg, pp, hd))
    torch.testing.assert_close(torch.cat(got, 1), want, atol=CHAIN_TOL,
                               rtol=CHAIN_TOL)


# ---------------------------------------------------------------------------
# the whole models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_model_prefill_and_decode_match_jax_f32(arch):
    check_prefill_and_decode(arch)


def test_mamba2_model_logits_bf16():
    check_prefill_and_decode("mamba2-370m", "bfloat16", tol=0.0,
                             atol=BF16_ATOL)


def test_jamba_model_sublayers_bf16():
    check_sublayers_bf16("jamba-v0.1-52b")


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_model_serve_tokens_match_jax_f32(arch, monkeypatch):
    check_serve_tokens(arch, monkeypatch)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_model_value_and_grad_matches_jax(arch):
    parts = check_value_and_grad(arch)
    assert (float(parts["moe_aux"]) > 0) == (arch == "jamba-v0.1-52b")


# ---------------------------------------------------------------------------
# the compute-dtype cast
# ---------------------------------------------------------------------------

CAST_ARCHS = ["qwen3-1.7b", "granite-moe-1b-a400m", "llama4-scout-17b-a16e",
              "mamba2-370m", "jamba-v0.1-52b"]


@pytest.mark.parametrize("arch", CAST_ARCHS)
def test_compute_params_casts_as_cast_blocks(arch):
    """Every layer leaf of ``compute_params`` has the bits of the
    reference's ``_cast_blocks`` (carried to the per-layer layout), on a
    tree with non-zero norm scales and Mamba-2's non-bf16 ``a_log``;
    ``final_norm`` stays float32, the matrices of the rest are cast."""
    jcfg, pcfg = configs(arch)
    jp = _jax_init(arch, 1)
    rng = np.random.default_rng(4)

    def perturb(path, a):
        name = jax.tree_util.keystr(path)
        if a.ndim <= 2 and ("scale" in name or "a_log" in name):
            return a + jnp.asarray(rng.normal(size=a.shape)
                                   .astype(np.float32) * 0.1)
        return a

    jp = jax.tree_util.tree_map_with_path(perturb, jp)
    pp = convert.params_from_numpy(pcfg, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    got = model.compute_params(pcfg, pp)
    want = jax.tree.map(np.asarray, jax_model._cast_blocks(jcfg, jp))
    stacked = convert.stack_layers(pcfg, got["layers"])
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(stacked)
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        assert str(g.dtype).split(".")[1] == str(w.dtype), path
        np.testing.assert_array_equal(
            g.view(torch.int16).numpy() if g.dtype == torch.bfloat16
            else g.numpy(), w.view(np.int16) if w.dtype == jnp.bfloat16
            else w, err_msg=jax.tree_util.keystr(path))
    assert got["final_norm"]["scale"].dtype == torch.float32
    assert got["embed"].dtype == pcfg.cdtype
