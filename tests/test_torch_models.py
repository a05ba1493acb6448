"""The port's LM serving path (``repro_torch.models``, ``configs``,
``launch/serve``) against the JAX package on the CPU, at the smoke size
of the configs (2 layers per period, d_model 64, 4/2 heads, head_dim 16,
vocab 128), with the JAX package's weights carried across by
``convert.params_from_numpy``.

Tolerances: float32 compute is where the algorithm is checked: logits,
hidden states, caches and layer outputs within atol/rtol 1e-4, and the
generated tokens equal. bfloat16 compute gets one looser case: logits
within atol 3e-2, tokens not compared (bf16 rounds at other places in
the two frameworks).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import attention as jax_attn
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention, convert, layers, model, steps
from repro_torch.launch import serve

TOL = 1e-4
BF16_ATOL = 3e-2
DENSE_ARCHS = ["qwen3-1.7b", "gemma2-9b", "gemma3-12b", "llama3-8b"]


def T(a):
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def N(t):
    return t.detach().float().numpy()


def configs(arch, **over):
    """(JAX config, port config) of one smoke arch, the same overrides."""
    return (dataclasses.replace(jax_smoke(arch), **over),
            dataclasses.replace(get_smoke_config(arch), **over))


def carried_params(jcfg, pcfg, seed=0):
    jp = jax_model.init_params(jcfg, jax.random.key(seed))
    tree = jax.tree.map(np.asarray, jp)
    return jp, convert.params_from_numpy(pcfg, tree, device="cpu")


def prompts(vocab, b=3, s=12, seed=0):
    return np.random.default_rng(seed).integers(1, vocab, (b, s)) \
        .astype(np.int32)


# ---------------------------------------------------------------------------
# layers and attention
# ---------------------------------------------------------------------------

def test_rmsnorm_rope_mlp_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32) * 0.1
    want = jax_layers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    got = layers.rmsnorm({"scale": T(scale)}, T(x))
    np.testing.assert_allclose(N(got), np.asarray(want), atol=TOL, rtol=TOL)

    pos = rng.integers(0, 4000, (2, 7)).astype(np.int32)
    for theta in (1e4, 1e6):
        want = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        got = layers.apply_rope(T(x), torch.from_numpy(pos), theta)
        np.testing.assert_allclose(N(got), np.asarray(want), atol=TOL,
                                   rtol=TOL)

    h = rng.normal(size=(2, 5, 16)).astype(np.float32)
    w = {k: rng.normal(size=s).astype(np.float32) * 0.2 for k, s in
         (("wi_gate", (16, 32)), ("wi_up", (16, 32)), ("wo", (32, 16)))}
    for act in ("silu", "gelu"):
        want = jax_layers.mlp({k: jnp.asarray(v) for k, v in w.items()},
                              jnp.asarray(h), act=act)
        got = layers.mlp({k: T(v) for k, v in w.items()}, T(h), act=act)
        np.testing.assert_allclose(N(got), np.asarray(want), atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("causal,window,softcap", [(True, None, None),
                                                   (True, 5, None),
                                                   (False, None, 20.0),
                                                   (True, 7, 30.0)])
def test_dense_and_chunked_attention_match_jax(causal, window, softcap):
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, 32, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 32, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 32, 2, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, logit_softcap=softcap)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = jax_attn.dense_attention(jq, jk, jv, **kw)
    got = attention.dense_attention(T(q), T(k), T(v), **kw)
    np.testing.assert_allclose(N(got), np.asarray(want), atol=TOL, rtol=TOL)
    want = jax_attn.chunked_attention(jq, jk, jv, chunk_size=8, **kw)
    got = attention.chunked_attention(T(q), T(k), T(v), chunk_size=8, **kw)
    np.testing.assert_allclose(N(got), np.asarray(want), atol=TOL, rtol=TOL)
    kv_len = np.asarray([9, 32], np.int32)       # offsets and live lengths
    want = jax_attn.dense_attention(jq[:, :4], jk, jv, q_offset=20,
                                    kv_len=jnp.asarray(kv_len), **kw)
    got = attention.dense_attention(T(q[:, :4]), T(k), T(v), q_offset=20,
                                    kv_len=torch.from_numpy(kv_len), **kw)
    np.testing.assert_allclose(N(got), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("window,softcap", [(None, None), (6, 25.0)])
def test_model_decode_attention_matches_jax(window, softcap):
    rng = np.random.default_rng(2)
    q = rng.normal(size=(3, 1, 4, 16)).astype(np.float32)
    kc = rng.normal(size=(3, 40, 2, 16)).astype(np.float32)
    vc = rng.normal(size=(3, 40, 2, 16)).astype(np.float32)
    kv_len = np.asarray([1, 17, 40], np.int32)
    kw = dict(window=window, logit_softcap=softcap)
    want = jax_attn.decode_attention(*map(jnp.asarray, (q, kc, vc)),
                                     kv_len=jnp.asarray(kv_len), **kw)
    got = attention.decode_attention(T(q), T(kc), T(vc),
                                     kv_len=torch.from_numpy(kv_len), **kw)
    np.testing.assert_allclose(N(got), np.asarray(want), atol=TOL, rtol=TOL)
    # the kernel entry point (its plain version on the CPU) agrees too
    got = attention.decode(T(q), T(kc), T(vc), kv_len=torch.from_numpy(kv_len),
                           impl="kernel", **kw)
    np.testing.assert_allclose(N(got), np.asarray(want), atol=TOL, rtol=TOL)


def test_auto_resolves_by_device():
    x = torch.zeros(1)
    assert attention.resolve_impl("auto", x, 2048) == "dense"
    assert attention.resolve_impl("auto", x, 4096) == "chunked"
    assert attention.resolve_impl("pallas", x, 16) == "kernel"
    assert attention.resolve_impl("chunked", x, 16) == "chunked"
    meta = torch.empty(1, device="meta")
    assert attention.resolve_impl("auto", meta, 16) == "dense"


# ---------------------------------------------------------------------------
# the model: prefill, decode steps, logits
# ---------------------------------------------------------------------------

def grown_jax_caches(jcfg, caches, b, s, max_len):
    grown = jax_model.init_cache(jcfg, b, max_len)
    return jax.tree.map(lambda d, c: d.at[:, :, :s].set(c), grown, caches)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_prefill_and_decode_match_jax_f32(arch):
    jcfg, pcfg = configs(arch, compute_dtype="float32")
    jp, pp = carried_params(jcfg, pcfg)
    toks = prompts(jcfg.vocab_size)
    b, s = toks.shape
    jh, jcaches = jax_model.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)})
    ph, pcaches = model.prefill(pcfg, pp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(N(ph), np.asarray(jh), atol=TOL, rtol=TOL)
    fh, aux = model.forward(pcfg, pp, {"tokens": torch.from_numpy(toks)})
    assert torch.equal(fh, ph) and float(aux) == 0.0
    jl = jax_model.logits_from_hidden(jcfg, jp, jh)
    pl = model.logits_from_hidden(pcfg, pp, ph)
    np.testing.assert_allclose(N(pl), np.asarray(jl), atol=TOL, rtol=TOL)
    stacked = convert.stack_layers(pcfg, pcaches)
    for jc, pc in zip(jcaches, stacked):
        for key in ("k", "v"):
            np.testing.assert_allclose(N(pc[key]), np.asarray(jc[key]),
                                       atol=TOL, rtol=TOL)

    # several decode steps from the grown caches, the same tokens fed
    max_len = s + 4
    jc = grown_jax_caches(jcfg, jcaches, b, s, max_len)
    pc = model.init_cache(pcfg, b, max_len, device="cpu")
    for dst, src in zip(pc, pcaches):
        dst["k"][:, :s] = src["k"]
        dst["v"][:, :s] = src["v"]
    kv_len = np.asarray([5, 9, 12], np.int32)
    feed = prompts(jcfg.vocab_size, b, 4, seed=3)
    for t in range(4):
        kv_len = kv_len + 1
        jh, jc = jax_model.decode_step_hidden(
            jcfg, jp, jc, jnp.asarray(feed[:, t:t + 1]), jnp.asarray(kv_len))
        ph, pc = model.decode_step_hidden(
            pcfg, pp, pc, torch.from_numpy(feed[:, t:t + 1]),
            torch.from_numpy(kv_len))
        np.testing.assert_allclose(N(ph), np.asarray(jh), atol=TOL, rtol=TOL)
    for jcc, pcc in zip(jc, convert.stack_layers(pcfg, pc)):
        np.testing.assert_allclose(N(pcc["k"]), np.asarray(jcc["k"]),
                                   atol=TOL, rtol=TOL)


def test_greedy_decode_matches_jax_f32():
    from repro.models import steps as jax_steps
    jcfg, pcfg = configs("llama3-8b", compute_dtype="float32")
    jp, pp = carried_params(jcfg, pcfg, seed=4)
    toks = prompts(jcfg.vocab_size, b=2, s=8, seed=6)
    _, jc = jax_steps.make_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(toks)})
    _, pc = steps.make_prefill_step(pcfg)(pp, {"tokens": torch.from_numpy(toks)})
    jc = grown_jax_caches(jcfg, jc, 2, 8, 14)
    grown = model.init_cache(pcfg, 2, 14, device="cpu")
    for dst, src in zip(grown, pc):
        dst["k"][:, :8] = src["k"]
        dst["v"][:, :8] = src["v"]
    kv_len = np.asarray([7, 9], np.int32)
    want, _, wlen = jax_steps.greedy_decode(
        jcfg, jp, jc, jnp.asarray(toks[:, -1:]), jnp.asarray(kv_len), 5)
    got, _, glen = steps.greedy_decode(
        pcfg, pp, grown, torch.from_numpy(toks[:, -1:]),
        torch.from_numpy(kv_len), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(glen.numpy(), np.asarray(wlen))


def test_prefill_and_decode_logits_bf16():
    """bfloat16 compute, the configs' own: logits within 3e-2."""
    jcfg, pcfg = configs("qwen3-1.7b")
    assert pcfg.cdtype == torch.bfloat16
    jp, pp = carried_params(jcfg, pcfg, seed=1)
    toks = prompts(jcfg.vocab_size, seed=4)
    jstep = jax.jit(lambda p, b: _jax_prefill_step(jcfg, p, b))
    jl, jc = jstep(jp, {"tokens": jnp.asarray(toks)})
    pl, pc = steps.make_prefill_step(pcfg)(
        model.compute_params(pcfg, pp), {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(N(pl), np.asarray(jl), atol=BF16_ATOL)
    kv_len = np.asarray([12, 12, 12], np.int32)
    tok = toks[:, -1:]
    jl2, _ = _jax_decode_step(jcfg, jp, jc, jnp.asarray(tok),
                              jnp.asarray(kv_len))
    pl2, _ = steps.make_decode_step(pcfg)(pp, pc, torch.from_numpy(tok),
                                          torch.from_numpy(kv_len))
    np.testing.assert_allclose(N(pl2), np.asarray(jl2), atol=BF16_ATOL)


def _jax_prefill_step(cfg, params, batch):
    from repro.models import steps as jax_steps
    return jax_steps.make_prefill_step(cfg)(params, batch)


def _jax_decode_step(cfg, params, caches, tok, kv_len):
    from repro.models import steps as jax_steps
    return jax_steps.make_decode_step(cfg)(params, caches, tok, kv_len)


def test_slice_matches_jax_pallas_flash_kernel():
    """The JAX model with attn_impl="pallas" reaches the Pallas flash
    kernel (interpret mode on the CPU; Sq <= 128); the port's "pallas"
    route reaches the kernel entry point (its plain version here)."""
    jcfg, pcfg = configs("gemma2-9b", compute_dtype="float32",
                         attn_impl="pallas")
    jp, pp = carried_params(jcfg, pcfg, seed=2)
    toks = prompts(jcfg.vocab_size, b=2, s=64, seed=5)
    jh, _ = jax_model.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)})
    ph, _ = model.prefill(pcfg, pp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(
        N(model.logits_from_hidden(pcfg, pp, ph)),
        np.asarray(jax_model.logits_from_hidden(jcfg, jp, jh)),
        atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# serve_batch
# ---------------------------------------------------------------------------

def test_serve_batch_tokens_match_jax_f32(monkeypatch):
    from repro.launch import serve as jax_serve
    jcfg, pcfg = configs("qwen3-1.7b", compute_dtype="float32")
    monkeypatch.setattr(jax_serve, "get_smoke_config", lambda arch: jcfg)
    want = jax_serve.serve_batch("qwen3-1.7b", num_requests=3,
                                 prompt_len=16, gen_len=6, seed=7)
    jp = jax_model.init_params(jcfg, jax.random.key(7))
    pp = convert.params_from_numpy(pcfg, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    got = serve.serve_batch("qwen3-1.7b", num_requests=3, prompt_len=16,
                            gen_len=6, seed=7, device="cpu", params=pp,
                            overrides={"compute_dtype": "float32"})
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert got["prefill_logits"].shape == (3, 1, 128)
    assert got["step_logits"].shape == (3, 6, 128)
    assert torch.equal(got["step_logits"].argmax(-1),
                       torch.from_numpy(got["generated"]).long())


def test_serve_batch_teacher_forcing_and_plain_route():
    """Forcing the generated tokens back in reproduces the same logits;
    the dense route agrees with the kernel route (plain versions)."""
    base = serve.serve_batch("gemma2-9b", num_requests=2, prompt_len=16,
                             gen_len=4, seed=1, device="cpu",
                             overrides={"compute_dtype": "float32"})
    forced = serve.serve_batch(
        "gemma2-9b", num_requests=2, prompt_len=16, gen_len=4, seed=1,
        device="cpu", force_tokens=base["generated"],
        overrides={"compute_dtype": "float32", "attn_impl": "dense"})
    np.testing.assert_array_equal(forced["generated"], base["generated"])
    torch.testing.assert_close(forced["step_logits"], base["step_logits"],
                               atol=TOL, rtol=TOL)


def test_serve_batch_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.serve_batch()


@pytest.mark.parametrize("entry", ["init_params", "init_cache"])
def test_model_init_defaults_to_cuda(monkeypatch, entry):
    cfg = get_smoke_config("qwen3-1.7b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = (cfg, 2, 8) if entry == "init_cache" else (cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(model, entry)(*args)
    # the meta device stays: shapes only, no card needed
    assert getattr(model, entry)(*args, device="meta")


def test_params_from_numpy_defaults_to_cuda(monkeypatch):
    jcfg, pcfg = configs("qwen3-1.7b")
    tree = jax.tree.map(np.asarray,
                        jax_model.init_params(jcfg, jax.random.key(0)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.params_from_numpy(pcfg, tree)


@pytest.mark.parametrize("arch,what", [("mamba2-370m", "mamba"),
                                       ("granite-moe-1b-a400m", "moe"),
                                       ("jamba-v0.1-52b", "mamba"),
                                       ("qwen2-vl-2b", "M-RoPE"),
                                       ("hubert-xlarge", "frames")])
def test_unported_blocks_raise(arch, what):
    cfg = get_smoke_config(arch)
    with pytest.raises(NotImplementedError, match=what):
        model.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.init_cache(cfg, 1, 4, device="cpu")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma3-12b", "qwen3-1.7b"])
def test_params_round_trip_exact(arch):
    jcfg, pcfg = configs(arch)
    tree = jax.tree.map(np.asarray,
                        jax_model.init_params(jcfg, jax.random.key(3)))
    back = convert.params_to_numpy(pcfg, convert.params_from_numpy(
        pcfg, tree, device="cpu"))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_port_init_matches_jax_shapes():
    for arch in DENSE_ARCHS:
        jcfg, pcfg = configs(arch)
        want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                            jax_model.abstract_params(jcfg))
        got = convert.params_to_numpy(
            pcfg, model.tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype),
                                 model.abstract_params(pcfg)))
        assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), got) == want
        assert pcfg.num_params() == jcfg.num_params()
