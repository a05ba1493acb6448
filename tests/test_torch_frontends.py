"""The port's vlm/audio front ends against the JAX package on the CPU:
M-RoPE (``layers.apply_mrope``), ``frontend_proj`` and the ``patches``
and ``frames`` embeddings, at the smoke size of qwen2-vl-2b (M-RoPE
sections (2, 3, 3), 24-dim patch embeddings) and hubert-xlarge (24-dim
frames, not causal, no rotary positions), with the JAX weights carried
across by ``convert.params_from_numpy``.

The qwen2-vl batches give t, h and w positions drawn apart from each
other: where all three repeat one arange, as the pipeline's do, an
M-RoPE that took a channel from the wrong component would pass.

Tolerances: ``apply_mrope`` in float32 within 1e-6 (the angles are the
same float32 values; cos and sin differ in the last bit between the two
libraries), in bf16 within one bf16 ulp of each value (the same float32
products, rounded once); the models in float32 within 1e-5 (logits,
hidden states, caches, losses), gradients within 1e-4 of each leaf's
largest |g| (``test_torch_train.assert_grads_close``); bf16 sublayer by
sublayer within 4 bf16 ulps (``test_torch_moe.check_sublayers_bf16``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import train as jax_train
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro.models import steps as jax_steps
from repro_torch.launch import train as port_train
from repro_torch.models import layers, model, steps
from test_torch_moe import (_bf16_close, carried, check_prefill_and_decode,
                            check_sublayers_bf16, configs)
from test_torch_train import assert_grads_close

TOL = 1e-5
MROPE_F32_ATOL = 1e-6
TRAIN_RTOL = 1e-4          # test_torch_train's, for launch.train.train
ARCHS = ["qwen2-vl-2b", "hubert-xlarge"]


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def N(t):
    return t.detach().float().numpy()


def frontend_batch(arch, b=3, s=16, seed=0, labels=False):
    """numpy inputs of the smoke config: qwen2-vl's patches (a quarter
    of ``s``), tokens and (3, b, s) positions with t, h and w drawn
    apart; hubert's frames."""
    cfg = configs(arch)[1]
    rng = np.random.default_rng(seed)
    if cfg.frontend == "frames":
        out = {"frames": rng.normal(size=(b, s, cfg.frontend_dim))
               .astype(np.float32)}
        ntok = s
    else:
        npch = s // 4
        ntok = s - npch
        pos = rng.integers(0, 4 * s, (3, b, s)).astype(np.int32)
        assert not (pos[0] == pos[1]).all() and not (pos[1] == pos[2]).all()
        out = {"patches": rng.normal(size=(b, npch, cfg.frontend_dim))
               .astype(np.float32),
               "tokens": rng.integers(1, cfg.vocab_size, (b, ntok))
               .astype(np.int32),
               "positions": pos}
    if labels:
        out["labels"] = rng.integers(0, cfg.vocab_size, (b, ntok)) \
            .astype(np.int32)
    return out


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_dim,sections", [(16, (2, 3, 3)),
                                               (128, (16, 24, 24))])
def test_apply_mrope_matches_jax(dtype, head_dim, sections):
    rng = np.random.default_rng(head_dim)
    x = rng.normal(size=(2, 9, 3, head_dim)).astype(np.float32)
    pos = np.stack([rng.integers(0, 4000, (2, 9)) for _ in range(3)]) \
        .astype(np.int32)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jax_layers.apply_mrope(jx, jnp.asarray(pos), 1e6,
                                             sections).astype(jnp.float32))
    got = layers.apply_mrope(T(x).to(getattr(torch, dtype)), T(pos), 1e6,
                             sections)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(N(got), want, atol=MROPE_F32_ATOL)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))
                      - 7)
        assert (np.abs(N(got) - want) <= ulp).all()
    # each component drives its own channels: not the RoPE of t alone
    rope_t = layers.apply_rope(T(x), T(pos[0]), 1e6)
    assert float((layers.apply_mrope(T(x), T(pos), 1e6, sections)
                  - rope_t).abs().max()) > 0.1


def test_apply_mrope_refuses_sections_off_the_half_dim():
    with pytest.raises(ValueError, match="sum"):
        layers.apply_mrope(torch.zeros(1, 2, 1, 16),
                           torch.zeros(3, 1, 2, dtype=torch.int32), 1e4,
                           (2, 3, 2))


# ---------------------------------------------------------------------------
# the models in float32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_qwen2_vl_prefill_and_decode_match_jax_f32(impl):
    """A patches batch with distinct t/h/w positions: prefill's hidden
    states, logits and caches, then four decode steps (M-RoPE at
    ``kv_len - 1`` in all three components); ``impl="kernel"`` takes the
    port's flash and decode entry points (their plain versions here)."""
    check_prefill_and_decode("qwen2-vl-2b", tol=TOL, atol=TOL,
                             batch=frontend_batch("qwen2-vl-2b"),
                             attn_impl=impl)


def test_qwen2_vl_matches_jax_pallas_flash_kernel():
    """The JAX model on the Pallas flash kernel (interpret mode on the
    CPU) against the port's kernel route, on the patches batch."""
    jcfg, pcfg = configs("qwen2-vl-2b", compute_dtype="float32",
                         attn_impl="pallas")
    jp, pp = carried(jcfg, pcfg, seed=2)
    bt = frontend_batch("qwen2-vl-2b", b=2, seed=5)
    jh, _ = jax_model.prefill(jcfg, jp, jax.tree.map(jnp.asarray, bt))
    ph, _ = model.prefill(pcfg, pp, {k: T(v) for k, v in bt.items()})
    np.testing.assert_allclose(
        N(model.logits_from_hidden(pcfg, pp, ph)),
        np.asarray(jax_model.logits_from_hidden(jcfg, jp, jh)),
        atol=TOL, rtol=TOL)


@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_hubert_forward_matches_jax_f32(impl):
    """``forward`` over a frames batch, then ``logits_from_hidden`` at
    every frame (untied output head, not causal)."""
    jcfg, pcfg = configs("hubert-xlarge", compute_dtype="float32")
    pcfg = dataclasses.replace(pcfg, attn_impl=impl)
    assert not pcfg.causal and not pcfg.use_rope
    jp, pp = carried(jcfg, pcfg, seed=1)
    bt = frontend_batch("hubert-xlarge")
    jh, _ = jax.jit(lambda p, b: jax_model.forward(jcfg, p, b))(
        jp, jax.tree.map(jnp.asarray, bt))
    ph, aux = model.forward(pcfg, pp, {k: T(v) for k, v in bt.items()})
    assert float(aux) == 0.0
    np.testing.assert_allclose(N(ph), np.asarray(jh), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(
        N(model.logits_from_hidden(pcfg, pp, ph)),
        np.asarray(jax_model.logits_from_hidden(jcfg, jp, jh)),
        atol=TOL, rtol=TOL)


@functools.cache
def jax_value_and_grad(arch):
    """jax.value_and_grad of the JAX loss_fn in float32 on the carried
    weights (seed 1) and ``frontend_batch(seed=2)``, shared by both
    routes of the port."""
    jcfg, _ = configs(arch, compute_dtype="float32")
    jp, _ = carried(jcfg, configs(arch)[1], seed=1)
    bt = frontend_batch(arch, b=2, seed=2, labels=True)
    return jax.jit(jax.value_and_grad(
        functools.partial(jax_steps.loss_fn, jcfg), has_aux=True))(
        jp, jax.tree.map(jnp.asarray, bt))


@pytest.mark.parametrize("impl", ["dense", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_value_and_grad_matches_jax(arch, impl):
    """Loss and every leaf's gradient, ``frontend_proj`` included, with
    the patch prefix's labels padded to -1 (qwen2-vl); ``impl="kernel"``
    takes the flash autograd function (plain forward and backward here).
    hubert's token table gets no gradient in either package (its front
    end is the frames)."""
    jcfg, pcfg = configs(arch, compute_dtype="float32")
    _, pp = carried(jcfg, pcfg, seed=1)
    bt = frontend_batch(arch, b=2, seed=2, labels=True)
    (wl, wparts), wg = jax_value_and_grad(arch)
    loss, parts, grads = steps.value_and_grad(
        dataclasses.replace(pcfg, attn_impl=impl), pp,
        {k: T(v) for k, v in bt.items()})
    np.testing.assert_allclose(N(loss), np.asarray(wl), rtol=TOL)
    np.testing.assert_allclose(N(parts["ce"]), np.asarray(wparts["ce"]),
                               rtol=TOL)
    assert_grads_close(pcfg, grads, wg)
    assert float(grads["frontend_proj"].abs().max()) > 0
    assert (float(grads["embed"].abs().max()) == 0) == (arch ==
                                                        "hubert-xlarge")


# ---------------------------------------------------------------------------
# bf16, sublayer by sublayer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_sublayers_bf16(arch):
    """The embedding (the front end's projection in bf16, and the token
    rows) against the JAX one, then each layer's attention and MLP
    sublayers from the JAX run's bf16 inputs."""
    jcfg, pcfg = configs(arch)
    jp, pp = carried(jcfg, pcfg, seed=1)
    bt = frontend_batch(arch)
    want, wpos = jax_model._embed_inputs(jcfg, jp, jax.tree.map(jnp.asarray,
                                                                bt))
    got, pos = model._embed_inputs(pcfg, model.compute_params(pcfg, pp),
                                   {k: T(v) for k, v in bt.items()})
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    _bf16_close(got, want, "embedding")
    np.testing.assert_array_equal(pos.numpy(), np.asarray(wpos))
    check_sublayers_bf16(arch, batch=bt)


# ---------------------------------------------------------------------------
# defaults and the training driver
# ---------------------------------------------------------------------------

def test_default_positions_match_jax():
    """Without ``positions``: (3, B, S) aranges under M-RoPE, (B, S)
    otherwise, as the reference makes them."""
    for arch in ARCHS:
        jcfg, pcfg = configs(arch, compute_dtype="float32")
        jp, pp = carried(jcfg, pcfg, seed=1)
        bt = frontend_batch(arch)
        bt.pop("positions", None)
        _, want = jax_model._embed_inputs(jcfg, jp, jax.tree.map(
            jnp.asarray, bt))
        _, got = model._embed_inputs(pcfg, pp, {k: T(v)
                                                for k, v in bt.items()})
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_train_matches_jax(arch, monkeypatch):
    """``launch.train.train`` for 2 steps in float32 from the JAX
    driver's own initial weights, with the config's microbatches
    (qwen2-vl 2: its (3, B, S) positions split on axis 1; hubert 4):
    finite losses, the same as the JAX driver's on the JAX pipeline's
    batches."""
    jcfg, pcfg = configs(arch, compute_dtype="float32")
    monkeypatch.setattr(jax_train, "get_smoke_config", lambda a: jcfg)
    monkeypatch.setattr(port_train, "get_smoke_config", lambda a: pcfg)
    kw = dict(steps=2, batch=4, seq=16, log_every=100,
              num_microbatches=pcfg.train_microbatches)
    want = jax_train.train(arch, **kw)
    _, pp = carried(jcfg, pcfg, seed=0)
    got = port_train.train(arch, device="cpu", params=pp, **kw)
    assert all(np.isfinite(got["losses"]))
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=TRAIN_RTOL)
