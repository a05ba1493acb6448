"""The Mamba-2 mixer split over ``model`` on one device
(``repro_torch/launch/fsdp.py``'s ``split_in_turn``,
``ModelSplit.run_staged``, ``mixer_channels``; ``models/model.py``'s
``mamba_split``; ``models/ssm.py``'s ``mamba2_share_bc``,
``mamba2_share_in`` and ``mamba2_share_out``): every rank's share
computed in turn, the gated norm's sums of squares and the partial
outputs summed in rank order where the all-reduces would sum them.

At the smoke width (d_model 64, d_inner 128, 8 SSD heads of 16, state
16, chunk 8; 2 x 16 tokens), seeded with numpy, norm scales, dt_bias, D
and conv_b drawn too:

* mamba2-370m's layer (the mixer alone) and jamba's first (the mixer and
  a dense MLP) split over m = 1, 2 and 4 against the whole layer, in
  float32 and bfloat16: the output, the input gradient and every leaf's
  gradient, each largest difference over the tensor's largest |value|
  within ``TOL``; at m = 1 nothing splits and all are equal bit for bit;
* the split mixer against JAX's ``mamba2_forward``
  (``repro/models/ssm.py``) on the same weights carried to the JAX
  layout by ``models/convert.py``,
  its output and gradients (``jax.vjp``) within ``JAX_TOL``;
* rank 0's x-channels scaled x100 (its columns of ``wx``), so that its
  channels' mean of squares is far from the others': the split still
  agrees with the whole, while normalising each rank by its own
  channels' statistic is off by more than 100 times the bound.

The stand-in cannot check the backward of the statistic's sum over the
ranks (autograd adds the ranks' partial gradients itself);
``tests/test_torch_tp.py``'s gloo ranks do.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jax_ssm
from repro_torch.configs import get_smoke_config
from repro_torch.launch import fsdp
from repro_torch.models import convert, model, ssm

ARCHS = ("mamba2-370m", "jamba-v0.1-52b")
BATCH, SEQ = 2, 16
# each tensor's largest difference over its largest |value|, split
# against whole. float32: the split re-associates the sum of squares,
# wo's rows, the products' input gradients and B/C's gradients over the
# ranks (measured 1.02e-5 at most, mamba2-370m's leaves at m = 4; the
# scaled case 5.6e-6); bfloat16: each such float32 sum is rounded once,
# as the whole layer rounds its own, but may land on the other side of
# a bf16 boundary (measured equal bit for bit on these inputs); the
# bounds are GRAD_TOL and BF16_GRAD_TOL of tests/test_torch_tp.py
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# against JAX, float32: the output as tests/test_torch_ssm.py holds the
# mixer (measured 3.4e-7), the gradients of each leaf's largest |g|
# (measured 8.6e-6)
JAX_TOL = {"out": 1e-5, "grad": 1e-4}
# x100 on rank 0's x-channels: normalising each rank by its own
# channels' mean of squares is then off by order 1 (measured 0.69 and
# 1.03 of the output's largest |value| at m = 2 and 4)
SCALE = 100.0


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max())


@functools.lru_cache(maxsize=None)
def _weights(arch: str, seed: int = 0):
    """The smoke config's seeded weights in the JAX package's layout
    (``convert.params_to_numpy``), float32 numpy (not to be written to),
    with the mixers' and norms' constant leaves drawn."""
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    tree = convert.params_to_numpy(cfg, model.init_params(cfg, seed, "cpu"))
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = path[-1].key if hasattr(path[-1], "key") else ""
        if name in ("scale", "dt_bias", "conv_b"):
            return a + rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        if name == "D":
            return a + rng.normal(0.0, 0.3, a.shape).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(draw, tree)


def _layer(arch: str, dtype: str, scale_rank0: int = 0):
    """(config, layer 0's weights in the compute dtype, requiring grad):
    the carried JAX weights; ``scale_rank0``: m, whose rank 0's columns
    of ``wx`` are scaled by SCALE."""
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype=dtype)
    full = convert.params_from_numpy(cfg, _weights(arch), "cpu")
    layer = full["layers"][0]
    if scale_rank0:
        wx = layer["mamba"]["wx"]
        wx[:, :wx.shape[1] // scale_rank0] *= SCALE
    return cfg, model.tree_map(
        lambda t: t.to(cfg.cdtype).requires_grad_(), layer)


def _inputs(cfg, seed: int = 1):
    rng = np.random.default_rng(seed)
    x, dy = (torch.from_numpy(rng.normal(0.0, 1.0, (BATCH, SEQ, cfg.d_model))
                              .astype(np.float32)).to(cfg.cdtype)
             for _ in range(2))
    return x.requires_grad_(), dy


def _run(cfg, layer, p, split, x, dy):
    """(output, gradients of x and of every leaf of ``layer``) of the
    layer's block on ``p`` (``split`` its stand-in, or None)."""
    spec = cfg.layer_spec(0)
    positions = torch.arange(SEQ).expand(BATCH, SEQ)
    y, _ = model._apply_block(cfg, spec, p, x, positions, None, split)
    return y, torch.autograd.grad(y, [x] + list(model._leaves(layer)), dy)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("m", (1, 2, 4))
@pytest.mark.parametrize("arch", ARCHS)
def test_split_mixer_matches_whole(arch, m, dtype):
    cfg, layer = _layer(arch, dtype)
    x, dy = _inputs(cfg)
    tree, split = fsdp.split_in_turn(cfg, 0, layer, m)
    want = ("mamba",) + (("mlp",) if arch == "jamba-v0.1-52b" else ())
    assert split.sublayers == (want if m > 1 else ())
    y0, g0 = _run(cfg, layer, layer, None, x, dy)
    y1, g1 = _run(cfg, layer, tree, split, x, dy)
    assert y1.dtype == cfg.cdtype and y1.shape == y0.shape
    if m == 1:                       # nothing splits: the same arithmetic
        assert torch.equal(y1, y0)
        assert all(torch.equal(a, b) for a, b in zip(g1, g0))
    assert _rel(y1, y0) <= TOL[dtype]
    for a, b in zip(g1, g0):
        assert torch.isfinite(a).all() and _rel(a, b) <= TOL[dtype]


def _jax_mixer(cfg, arch: str, x: np.ndarray, dy: np.ndarray):
    """JAX's ``mamba2_forward`` of layer 0's mixer: (output, gradients of
    the mixer's leaves in the port's order, of x)."""
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      _weights(arch)["blocks"][0]["mamba"])
    fn = functools.partial(
        jax_ssm.mamba2_forward, state=cfg.ssm_state, conv=cfg.ssm_conv,
        expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim,
        chunk=cfg.ssm_chunk, norm_eps=cfg.norm_eps)

    @jax.jit
    def run(p, xj, dyj):
        out, vjp = jax.vjp(fn, p, xj)
        return (out,) + vjp(dyj)
    return run(jp, jnp.asarray(x), jnp.asarray(dy))


@pytest.mark.parametrize("m", (2, 4))
def test_split_mixer_matches_jax(m):
    arch = "mamba2-370m"
    cfg, layer = _layer(arch, "float32")
    x, dy = _inputs(cfg)
    tree, split = fsdp.split_in_turn(cfg, 0, layer, m)
    y = model.mamba_split(cfg, split, tree["mamba"], x)
    leaves = list(model._leaves(layer["mamba"]))
    got = torch.autograd.grad(y, leaves + [x], dy)
    want, gp, gx = _jax_mixer(cfg, arch, x.detach().numpy(), dy.numpy())
    assert _rel(y, torch.from_numpy(np.array(want))) <= JAX_TOL["out"]
    jleaves = [gp[k] if k != "norm" else gp[k]["scale"]
               for k in layer["mamba"]] + [gx]
    for a, b in zip(got, jleaves):
        assert _rel(a, torch.from_numpy(np.array(b))) <= JAX_TOL["grad"]


@pytest.mark.parametrize("m", (2, 4))
def test_scaled_rank_channels_need_the_summed_statistic(m):
    """Rank 0's x-channels x100: the split mixer still agrees with the
    whole (``TOL``), and a statistic of each rank's own channels would
    not (off by more than 100 x ``TOL``)."""
    arch = "mamba2-370m"
    cfg, layer = _layer(arch, "float32", scale_rank0=m)
    x, dy = _inputs(cfg)
    tree, split = fsdp.split_in_turn(cfg, 0, layer, m)
    whole = model.mamba_split(cfg, fsdp.ModelSplit(None, ("mamba",)),
                              [layer["mamba"]], x)
    ref = ssm.mamba2_forward(layer["mamba"], x, chunk=cfg.ssm_chunk,
                             **model._ssm_kw(cfg))
    y = model.mamba_split(cfg, split, tree["mamba"], x)
    assert torch.allclose(whole, ref, rtol=1e-6, atol=1e-6)
    assert _rel(y, ref) <= TOL["float32"]
    leaves = [x] + list(model._leaves(layer["mamba"]))
    for a, b in zip(torch.autograd.grad(y, leaves, dy),
                    torch.autograd.grad(ref, leaves, dy)):
        assert _rel(a, b) <= TOL["float32"]
    # each rank normalised by its own channels' mean of squares
    d_inner = cfg.ssm_expand * cfg.d_model
    with torch.no_grad():
        xs = tuple(x.float() for _ in range(5))
        bc = ssm.mamba2_share_bc(tree["mamba"][0], xs,
                                 state=cfg.ssm_state).float()
        own = sum(ssm.mamba2_share_out(
            q, *ssm.mamba2_share_in(q, xs, bc, state=cfg.ssm_state,
                                    head_dim=cfg.ssm_head_dim,
                                    chunk=cfg.ssm_chunk),
            d_inner // m, cfg.norm_eps) for q in tree["mamba"])
    assert _rel(own, ref) > 100 * TOL["float32"]
