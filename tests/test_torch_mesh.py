"""The port's LM mesh rules (``repro_torch/launch/mesh.py``) against the
JAX package's (``repro/launch/mesh.py``) on the reference's pod meshes,
16 x 16 and 2 x 16 x 16, for all ten archs at full width, on the meta
device (no process group: specs need only axis names and sizes).

The JAX tree stacks each layer leaf on a leading K axis; port layer i
is JAX period slot i % period, and its spec is the JAX spec without the
first entry. The dry run's per-device argument bytes on a pod mesh are
held exactly against the sum of ``NamedSharding(mesh, spec).
shard_shape`` bytes over the JAX trees. ``sharding.block`` is held, on
2 x 2 and 2 x 2 x 2 meshes, to reassemble every leaf of each smoke
config exactly, in JAX's block order (major axis first).
"""
import functools
import itertools
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from repro import compat
from repro.configs import get_config as jax_config
from repro.configs import input_specs as jax_input_specs
from repro.launch import mesh as jax_mesh
from repro.models import model as jax_model
from repro.optim import adamw_init as jax_adamw_init
from repro_torch import sharding
from repro_torch.configs import (ARCHS, SHAPES, get_config,
                                 get_smoke_config, input_specs, supported)
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model

MESHES = {"16x16": False, "2x16x16": True}


def meshes(multi: bool):
    """(JAX abstract mesh, the port's MeshShape) of one pod mesh."""
    shape, names = (((2, 16, 16), ("pod", "data", "model")) if multi
                    else ((16, 16), ("data", "model")))
    return (compat.make_abstract_mesh(shape, names),
            mesh_lib.MeshShape(shape, names))


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    return jax_model.abstract_params(jax_config(arch))


@functools.lru_cache(maxsize=None)
def jax_opt(arch):
    return jax.eval_shape(jax_adamw_init, jax_params(arch))


@functools.lru_cache(maxsize=None)
def port_params(arch):
    return model.abstract_params(get_config(arch))


def jax_flat(tree, specs) -> dict:
    """{path: (leaf, spec tuple)} of a JAX tree and its PartitionSpecs."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    sp = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(sp)
    return {jax_mesh._path_str(p): (leaf, tuple(s))
            for (p, leaf), s in zip(leaves, sp)}


def port_flat(tree, specs) -> dict:
    """{path: (leaf, spec)} of a port tree and its spec tree."""
    out = {}
    mesh_lib.map_with_path(lambda p, t: out.setdefault(p, [t]), tree)
    leaves = dict(out)
    for (path, (t,)), (_, s) in zip(leaves.items(),
                                    mesh_lib.zip_specs(tree, specs)):
        out[path] = (t, s)
    return out


def jax_path(cfg, path: str, root: str | None = "layers",
             jroot: str = "blocks"):
    """(A port path's JAX path: layer i -> its period slot, whether the
    JAX leaf is stacked on K). ``root`` None: the tree is a list of
    layers (the caches)."""
    parts = path.split("/")
    if root is None:
        parts[0] = str(int(parts[0]) % cfg.period)
        return "/".join(parts), True
    if parts[0] != root:
        return path, False
    parts[0] = jroot
    parts[1] = str(int(parts[1]) % cfg.period)
    return "/".join(parts), True


def assert_specs_match(cfg, got: dict, want: dict, root="layers",
                       jroot="blocks"):
    """Every port leaf's spec equals its JAX leaf's (K dropped for layer
    leaves), and every JAX leaf is someone's."""
    seen = set()
    for path, (t, spec) in got.items():
        jp, stacked = jax_path(cfg, path, root, jroot)
        leaf, jspec = want[jp]
        seen.add(jp)
        if stacked:
            assert tuple(t.shape) == tuple(leaf.shape[1:]), path
            assert spec == jspec[1:], (path, spec, jspec)
        else:
            assert tuple(t.shape) == tuple(leaf.shape), path
            assert spec == jspec, (path, spec, jspec)
    assert seen == set(want)


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch, mesh_name):
    cfg = get_config(arch)
    amesh, mesh = meshes(MESHES[mesh_name])
    tree = port_params(arch)
    got = port_flat(tree, mesh_lib.param_specs(cfg, mesh, tree))
    jtree = jax_params(arch)
    want = jax_flat(jtree, jax_mesh.param_specs(jax_config(arch), amesh,
                                                jtree))
    assert len(got) == sum(
        leaf.shape[0] if p.startswith("blocks/") else 1
        for p, (leaf, _) in want.items())
    assert_specs_match(cfg, got, want)


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_specs_match_jax(arch, mesh_name):
    cfg = get_config(arch)
    amesh, mesh = meshes(MESHES[mesh_name])
    got = mesh_lib.opt_specs(mesh_lib.param_specs(cfg, mesh))
    jtree = jax_params(arch)
    want = jax_mesh.opt_specs(jax_config(arch), amesh, jax_opt(arch))
    assert set(got) == set(want) == {"step", "m", "v"}
    assert got["step"] == tuple(want["step"]) == ()
    tree = port_params(arch)
    for key in ("m", "v"):
        assert_specs_match(cfg, port_flat(tree, got[key]),
                           jax_flat(jtree, want[key]))


def cells(arch):
    return [s for s in SHAPES if supported(arch, s)]


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_jax(arch, mesh_name):
    """``batch_specs`` of every cell's batch (and of decode's tokens and
    kv_len, which the JAX dry run shards by the same rule), and
    ``cache_specs`` of the decode cells' caches."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    amesh, mesh = meshes(MESHES[mesh_name])
    for shape in cells(arch):
        got_in, want_in = input_specs(cfg, shape), jax_input_specs(jcfg,
                                                                   shape)
        if SHAPES[shape]["kind"] == "decode":
            b = want_in["tokens"].shape[0]
            bax = jax_mesh._sh(amesh, b, jax_mesh.BATCH)
            io = {"tokens": got_in["tokens"], "kv_len": got_in["kv_len"]}
            got = mesh_lib.batch_specs(cfg, mesh, io)
            assert got == {"tokens": (bax, None), "kv_len": (bax,)}, shape
            jc = jax_mesh.cache_specs(jcfg, amesh, want_in["caches"])
            pc = mesh_lib.cache_specs(cfg, mesh, got_in["caches"])
            assert_specs_match(cfg, port_flat(got_in["caches"], pc),
                               jax_flat(want_in["caches"], jc), root=None)
        else:
            got = mesh_lib.batch_specs(cfg, mesh, got_in["batch"])
            want = jax_mesh.batch_specs(jcfg, amesh, want_in["batch"])
            assert got == {k: tuple(v) for k, v in want.items()}, shape


def shard_bytes(tree, specs, amesh) -> int:
    leaves = jax.tree.leaves(tree)
    sp = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    return sum(math.prod(NamedSharding(amesh, s).shard_shape(x.shape))
               * np.dtype(x.dtype).itemsize for x, s in zip(leaves, sp))


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_device_bytes_match_jax_shards(arch, mesh_name):
    """The pod-mesh dry run's argument bytes per device, by part, equal
    the JAX trees' shard bytes under the JAX specs, exactly."""
    multi = MESHES[mesh_name]
    jcfg = jax_config(arch)
    amesh, _ = meshes(multi)
    jtree = jax_params(arch)
    pbytes = shard_bytes(jtree, jax_mesh.param_specs(jcfg, amesh, jtree),
                         amesh)
    for shape in cells(arch):
        r = dryrun.run_mesh_cell(arch, shape, multi)
        assert r["mesh"] == mesh_name and r["chips"] == amesh.size
        assert r["memory"]["peak"] == "not estimated"
        got = r["memory"]["argument_bytes_by_part"]
        spec = jax_input_specs(jcfg, shape)
        want = {"params": pbytes}
        kind = SHAPES[shape]["kind"]
        if kind == "train":
            jopt = jax_opt(arch)
            want["opt"] = shard_bytes(
                jopt, jax_mesh.opt_specs(jcfg, amesh, jopt), amesh)
        if kind in ("train", "prefill"):
            want["batch"] = shard_bytes(
                spec["batch"], jax_mesh.batch_specs(jcfg, amesh,
                                                    spec["batch"]), amesh)
        else:
            want["caches"] = shard_bytes(
                spec["caches"], jax_mesh.cache_specs(jcfg, amesh,
                                                     spec["caches"]), amesh)
            bax = jax_mesh._sh(amesh, spec["tokens"].shape[0],
                               jax_mesh.BATCH)
            want["tokens"] = shard_bytes(spec["tokens"], P(bax, None), amesh)
            want["kv_len"] = shard_bytes(spec["kv_len"], P(bax), amesh)
        assert got == want, (arch, shape)
        assert r["memory"]["argument_bytes_per_device"] == sum(want.values())


SMALL = {"2x2": mesh_lib.MeshShape((2, 2), ("data", "model")),
         "2x2x2": mesh_lib.MeshShape((2, 2, 2), ("pod", "data", "model"))}


def reassemble(full: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """Every rank's ``sharding.block`` written back at the offset JAX gives
    it (a dim over axes (a, b) split size(a) * size(b) ways, block
    index coord(a) * size(b) + coord(b)); each element must be written
    by as many ranks as hold it."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    out = torch.zeros_like(full)
    hits = torch.zeros(full.shape, dtype=torch.int64)
    for coords in itertools.product(*(range(n) for n in mesh.shape)):
        c = dict(zip(mesh.axis_names, coords))
        got = sharding.block(full, spec, mesh, coords)
        where = []
        for d, entry in enumerate(spec):
            axes = sharding.entry_axes(entry)
            ways = math.prod(sizes[a] for a in axes)
            idx = int(np.ravel_multi_index(
                [c[a] for a in axes], [sizes[a] for a in axes])) \
                if axes else 0
            n = full.shape[d] // ways
            where.append(slice(idx * n, (idx + 1) * n))
        assert tuple(got.shape) == sharding.block_shape(full.shape, spec,
                                                        mesh)
        out[tuple(where)] = got
        hits[tuple(where)] += 1
    copies = math.prod(mesh.shape) // math.prod(
        sizes[a] for a in sharding.spec_axes(spec))
    assert bool((hits == copies).all())
    return out


@pytest.mark.parametrize("mesh_name", SMALL)
@pytest.mark.parametrize("arch", ARCHS)
def test_blocks_reassemble_every_leaf(arch, mesh_name):
    """``block`` over every coordinate gives each leaf back exactly;
    ``placements`` shards the same dims."""
    from torch.distributed.tensor import Shard
    mesh = SMALL[mesh_name]
    cfg = get_smoke_config(arch)
    params = model.init_params(cfg, 0, "cpu")
    specs = mesh_lib.param_specs(cfg, mesh, params)
    split = 0
    for t, spec in mesh_lib.zip_specs(params, specs):
        assert torch.equal(reassemble(t, spec, mesh), t)
        split += bool(sharding.spec_axes(spec))
        pl = mesh_lib.placements(spec, mesh)
        for name, p in zip(mesh.axis_names, pl):
            dims = [d for d, e in enumerate(spec)
                    if name in sharding.entry_axes(e)]
            assert (p == Shard(dims[0])) if dims else p.is_replicate()
    assert split > 0
