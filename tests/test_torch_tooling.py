"""The port's tooling against the JAX package's, on the CPU:
``configs.input_specs`` and the one-card dry run (``launch/dryrun.py``)
against JAX's ``input_specs``/``abstract_params``/``adamw_init`` shapes
for every supported (arch x shape) cell; the kernel entries' meta shape
functions against their plain versions; the linter
(``core/analysis/lint.py``: DET, CAP, OBS, KRN); the plan verifier
(``core/analysis/verify.py``) line for line against JAX's; the three
examples; and ``chip_smoke.py`` phase 13 rehearsed at the smoke size.
Shapes and byte counts are compared exactly.
"""
import math
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import input_specs as jax_input_specs
from repro.core.analysis import verify as jax_verify
from repro.models import model as jax_model
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.configs import (ARCHS, SHAPES, get_config, input_specs,
                                 supported)
from repro_torch.core.analysis import lint, verify
from repro_torch.kernels import decode_attention, flash_attention, ops
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
CELLS = [(a, s) for a in ARCHS for s in SHAPES if supported(a, s)]


def _jax_bytes(tree) -> int:
    return sum(math.prod(x.shape) * np.dtype(x.dtype).itemsize
               for x in jax.tree.leaves(tree))


def _sig(t):
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


def _jsig(x):
    return tuple(x.shape), np.dtype(x.dtype).name


# ---------------------------------------------------------------------------
# input_specs and the dry run's argument bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_jax(arch, shape):
    """Keys, shapes and dtypes of every input; the caches one per layer
    where JAX stacks each period position's on a leading K axis."""
    cfg = get_config(arch)
    got = input_specs(cfg, shape)
    want = jax_input_specs(jax_config(arch), shape)
    assert set(got) == set(want)
    for key, w in want.items():
        if key == "caches":
            period = cfg.period
            assert len(got[key]) == cfg.num_layers
            for i, layer in enumerate(got[key]):
                wl = w[i % period]
                assert set(layer) == set(wl)
                for name, t in layer.items():
                    assert t.is_meta
                    shp, dt = _jsig(wl[name])
                    assert _sig(t) == (shp[1:], dt), (i, name)
        elif isinstance(w, dict):
            assert set(got[key]) == set(w)
            for name, t in got[key].items():
                assert t.is_meta and _sig(t) == _jsig(w[name]), name
        else:
            assert got[key].is_meta and _sig(got[key]) == _jsig(w), key


@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_argument_bytes_match_jax(arch):
    """Per supported cell: params (+ AdamW state for train) + inputs, in
    bytes, against JAX's abstract trees; no storage is allocated."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    jparams = jax_model.abstract_params(jcfg)
    jopt = jax.eval_shape(jax_adamw_init, jparams)
    for shape in SHAPES:
        if not supported(arch, shape):
            continue
        _, args = dryrun.build_step_and_args(cfg, shape)
        assert all(t.is_meta for t in dryrun._leaves(args))
        want = _jax_bytes(jparams) + _jax_bytes(
            jax_input_specs(jcfg, shape))
        if SHAPES[shape]["kind"] == "train":
            want += _jax_bytes(jopt)
        assert dryrun.tree_bytes(args) == want, (arch, shape)


def test_dryrun_one_smoke_cell(capsys, tmp_path):
    rc = dryrun.main(["--smoke", "--arch", "qwen3-1.7b", "--shape",
                      "train_4k", "--batch", "2", "--seq", "64",
                      "--set", "head_dim=64", "--device-bytes", str(2**30),
                      "--outdir", str(tmp_path), "--tag", "t"])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.splitlines()[-1] == "done: 1/1 cells OK"
    assert out.startswith("OK   qwen3-1.7b x train_4k (2 x 64)")
    (rec,) = tmp_path.glob("qwen3-1.7b_train_4k_1xH100.t.json")
    import json
    r = json.loads(rec.read_text())
    m = r["memory"]
    assert m["argument_bytes"] == sum(m["argument_bytes_by_part"].values())
    assert m["estimated_peak_bytes"] > m["argument_bytes"] and m["fits"]
    assert r["roofline"]["dominant"] in ("compute_s", "memory_s")


def test_dryrun_refuses_what_the_kernels_refuse(capsys):
    """The smoke config's 16-wide heads: the flash wrapper's check runs on
    meta tensors as on the card, and the cell fails."""
    rc = dryrun.main(["--smoke", "--arch", "qwen3-1.7b", "--shape",
                      "train_4k", "--batch", "2", "--seq", "64",
                      "--device-bytes", str(2**30)])
    out = capsys.readouterr().out
    assert rc == 1 and "head_dim 16" in out
    assert out.splitlines()[-1] == "done: 0/1 cells OK"


def test_peak_tracker_counts_live_storages():
    x = torch.empty(1000, device="meta")
    with dryrun.PeakTracker([x]) as tr:
        a = x * 2                        # 4000 bytes
        b = a.view(10, 100) + 1          # 4000 more, a still alive
        del a
        c = b.sum()                      # 4 bytes; b's 4000 alive
        del b, c
    assert tr.peak == 8000 and tr.now == 0


def test_peak_tracker_counts_storages_at_freed_argument_addresses():
    """An argument freed during the step leaves the tracker's known set:
    a new storage at its address is counted (the estimate of a Mamba-2
    decode cell, whose caches are replaced, repeats from run to run)."""
    args = [torch.empty(10, device="meta")]
    with dryrun.PeakTracker(args) as tr:
        assert len(tr.known) == 1
        args.clear()
        assert tr.known == {}
        ys = [torch.empty(m, device="meta") for m in (10, 1, 2, 3)]
    assert tr.peak == tr.now == 4 * (10 + 1 + 2 + 3) and len(ys) == 4


def test_dots_peak_exceeds_full_by_the_saved_products():
    """On qwen3's smoke config at head_dim 64, "dots" keeps each layer's
    q, k, v, o, gate, up and down products (bf16) alive into the backward:
    its estimated peak grows by at most their bytes over every layer."""
    kw = dict(budget=2**30, smoke=True, batch=2, seq=64, microbatches=1)
    got = {p: dryrun.run_cell("qwen3-1.7b", "train_4k", overrides={
        "head_dim": 64, "remat": True, "remat_policy": p}, **kw)
        for p in ("full", "dots")}
    cfg = got["full"]
    assert cfg["memory"]["argument_bytes"] == \
        got["dots"]["memory"]["argument_bytes"]
    extra = (got["dots"]["memory"]["estimated_peak_bytes"]
             - cfg["memory"]["estimated_peak_bytes"])
    from repro_torch.configs import get_smoke_config
    c = get_smoke_config("qwen3-1.7b")
    per_token = (2 * 4 * 64 + 2 * 2 * 64 + 3 * c.d_ff + c.d_model) * 2
    assert 0 < extra <= per_token * 2 * 64 * c.num_layers


# ---------------------------------------------------------------------------
# meta shape functions of the kernel entries
# ---------------------------------------------------------------------------

def _pairs(*ts):
    """(meta copy, cpu tensor) of each tensor."""
    return [t.to("meta") for t in ts], list(ts)


def _same(meta, cpu):
    if isinstance(meta, torch.Tensor):
        assert meta.is_meta and _sig(meta) == _sig(cpu)
        return
    assert len(meta) == len(cpu)
    for m, c in zip(meta, cpu):
        _same(m, c)


def _counts():
    from repro_torch.kernels import hash_join, seg_aggregate, seg_topk
    return (flash_attention.flash_attention_bhsd.launches,
            flash_attention.flash_attention_bwd_bhsd.launches,
            decode_attention.decode_attention_bhgd.launches,
            hash_join.block_join_probe.launches,
            seg_aggregate.segmented_aggregate.launches,
            seg_aggregate.segmented_sum_count.launches,
            seg_topk.segment_topk.launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_meta_outputs_match_plain(dtype):
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 40, 4, 64, generator=gen).to(dtype)
    k = torch.randn(2, 40, 2, 64, generator=gen).to(dtype)
    v = torch.randn(2, 40, 2, 64, generator=gen).to(dtype)
    before = _counts()
    (mq, mk, mv), _ = _pairs(q, k, v)
    _same(ops.flash_attention(mq, mk, mv), ops.flash_attention(q, k, v))
    kw = dict(g=2, causal=True, window=None, softcap=None, scale=None)
    bh = [t.transpose(1, 2) for t in (q, k, v)]
    mbh = [t.transpose(1, 2) for t in (mq, mk, mv)]
    o, lse = flash_attention._plain(*bh, return_lse=True, **kw)
    mo, mlse = flash_attention.flash_attention_bhsd(*mbh, return_lse=True,
                                                    **kw)
    _same((mo, mlse), (o, lse))
    do = torch.randn(o.shape, generator=gen).to(dtype)
    _same(flash_attention.flash_attention_bwd_bhsd(
        *mbh, mo, do.to("meta"), mlse, **kw),
        flash_attention._plain_bwd(*bh, o, do, lse, **kw))
    # the autograd function on meta leaves: forward and backward
    leaves = [t.detach().requires_grad_() for t in (mq, mk, mv)]
    ops.flash_attention(*leaves).sum().backward()
    for leaf, t in zip(leaves, (q, k, v)):
        assert _sig(leaf.grad) == _sig(t)
    cache_k = torch.randn(2, 48, 2, 64, generator=gen).to(dtype)
    cache_v = torch.randn(2, 48, 2, 64, generator=gen).to(dtype)
    q1 = q[:, :1].contiguous()
    kv_len = torch.tensor([5, 48], dtype=torch.int32)
    _same(ops.decode_attention(*_pairs(q1, cache_k, cache_v, kv_len)[0]),
          ops.decode_attention(q1, cache_k, cache_v, kv_len))
    assert _counts() == before


def test_query_kernel_meta_outputs_match_plain():
    rng = np.random.default_rng(0)
    p, nb, np_, n, s, c = 2, 50, 70, 300, 17, 3
    bk = tuple(torch.from_numpy(rng.integers(0, 9, (p, nb), dtype=np.int32))
               for _ in range(2))
    pk = tuple(torch.from_numpy(rng.integers(0, 9, (p, np_), dtype=np.int32))
               for _ in range(2))
    bv = torch.from_numpy(rng.random((p, nb)) < 0.8)
    pv = torch.from_numpy(rng.random((p, np_)) < 0.8)
    before = _counts()
    meta = lambda ts: tuple(t.to("meta") for t in ts)  # noqa: E731
    _same(ops.hash_join_probe(meta(bk), bv.to("meta"), meta(pk),
                              pv.to("meta")),
          ops.hash_join_probe(bk, bv, pk, pv))
    vals = torch.from_numpy(rng.normal(size=(p, n, c)).astype(np.float32))
    ok = torch.from_numpy(rng.random((p, n, c)) < 0.9)
    seg = torch.from_numpy(rng.integers(0, s, (p, n), dtype=np.int32))
    valid = torch.from_numpy(rng.random((p, n)) < 0.7)
    _same(ops.segmented_aggregate(*meta((vals, ok, seg, valid)), s),
          ops.segmented_aggregate(vals, ok, seg, valid, s))
    _same(ops.segmented_sum_count(*meta((vals[..., 0], seg, valid)), s),
          ops.segmented_sum_count(vals[..., 0], seg, valid, s))
    keys = (torch.from_numpy((~valid.numpy()).astype(np.int32)), seg,
            vals[..., 1].contiguous())
    _same(ops.segment_topk(meta(keys), 9), ops.segment_topk(keys, 9))
    assert _counts() == before


def test_kernel_wrappers_still_refuse_cpu_tensors():
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention_bhsd(q, q, q, g=1)


# ---------------------------------------------------------------------------
# the linter (mirrors tests/test_analysis.py's and tests/test_obs.py's)
# ---------------------------------------------------------------------------

def _codes(findings):
    return [f.code for f in findings]


def test_lint_wall_clock_in_core():
    src = "t = time.perf_counter()\n"
    assert _codes(lint.lint_source(
        src, "repro_torch/core/serving/x.py")) == ["DET001"]
    assert lint.lint_source(src, "repro_torch/launch/bench.py") == []


def test_lint_unseeded_rng_in_core():
    bad = "x = np.random.rand(3)\n"
    good = "rng = np.random.default_rng(0)\n"
    assert _codes(lint.lint_source(
        bad, "repro_torch/core/workload.py")) == ["DET002"]
    assert lint.lint_source(good, "repro_torch/core/workload.py") == []
    assert _codes(lint.lint_source(
        "random.shuffle(x)\n", "repro_torch/core/x.py")) == ["DET002"]


@pytest.mark.parametrize("src,codes", [
    ("torch.manual_seed(0)\n", ["DET002"]),
    ("x = torch.randn(3)\n", ["DET002"]),
    ("x = torch.randint(0, 9, (3,))\n", ["DET002"]),
    ("x = torch.randperm(5)\n", ["DET002"]),
    ("x = torch.multinomial(p, 2)\n", ["DET002"]),
    ("x = torch.randn(3, generator=g)\n", []),
    ("x = torch.bernoulli(p, generator=g)\n", []),
    ("g = torch.Generator().manual_seed(0)\n", []),
    ("x = torch.zeros(3)\n", []),
])
def test_lint_torch_global_rng_in_core(src, codes):
    assert _codes(lint.lint_source(src, "repro_torch/core/x.py")) == codes
    # outside core/ the DET rules do not apply
    assert lint.lint_source(src, "repro_torch/models/x.py") == []


def test_lint_waiver_suppresses():
    src = "t = time.perf_counter()  # lint: allow(DET001)\n"
    assert lint.lint_source(src, "repro_torch/core/x.py") == []
    prev = ("# lint: allow(DET002)\n"
            "torch.manual_seed(0)\n")
    assert lint.lint_source(prev, "repro_torch/core/x.py") == []
    other = "t = time.perf_counter()  # lint: allow(DET002)\n"
    assert _codes(lint.lint_source(
        other, "repro_torch/core/x.py")) == ["DET001"]


def test_lint_port_is_clean():
    findings = lint.lint_paths([str(SRC / "repro_torch"),
                                str(ROOT / "chip_smoke.py")])
    findings += lint.lint_registry(str(SRC))
    findings += lint.lint_metrics(str(SRC))
    findings += lint.lint_kernel_registry(str(SRC))
    assert findings == [], "\n".join(str(f) for f in findings)


def test_lint_cli_exit_codes(tmp_path, capsys):
    assert lint.main([str(SRC / "repro_torch")]) == 0
    assert "lint clean" in capsys.readouterr().out
    bad = tmp_path / "repro_torch" / "core" / "x.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("torch.manual_seed(0)\n")
    assert lint.main([str(bad)]) == 1
    assert "DET002" in capsys.readouterr().out


def test_lint_registry_catches_orphan_flag(tmp_path):
    (tmp_path / "repro_torch" / "core").mkdir(parents=True)
    (tmp_path / "repro_torch" / "core" / "executor.py").write_text(
        "class ExecConfig:\n"
        "    scan_cap: int = 0\n"
        "    group_cap: int = 0\n"
        'OVERFLOW_FLAGS: dict = {"scan_cap": "overflow_scan"}\n')
    (tmp_path / "repro_torch" / "core" / "service.py").write_text("x = 1\n")
    codes = _codes(lint.lint_registry(str(tmp_path)))
    assert "CAP001" in codes       # group_cap has no registry entry
    assert "CAP002" in codes       # flag never ctx.note()d
    assert "CAP003" in codes       # no regrowth rung
    assert "CAP004" in codes       # never presized


def test_lint_obs_rules(tmp_path):
    src = ("class S:\n    def f(self, k):\n"
           "        self.stats.bogus += 1\n"
           "        self.stats.ghost[k] = self.stats.ghost.get(k, 0) + 1\n"
           "        self.stats.compiles += 1\n"
           "        self.stats.secret += 1  # lint: allow(OBS001)\n")
    found = lint.lint_stats_sources([("x.py", src)], {"compiles"})
    assert _codes(found) == ["OBS001", "OBS001"]
    assert "bogus" in found[0].message and found[0].line == 3
    core = tmp_path / "repro_torch" / "core"
    (core / "obs").mkdir(parents=True)
    (core / "serving").mkdir()
    (core / "obs" / "metrics.py").write_text(
        'REGISTERED_STATS = {"compiles": "compiles_total", '
        '"phantom": "phantom_total"}\n')
    (core / "service.py").write_text(
        "class ServiceStats:\n    compiles: int = 0\n")
    (core / "serving" / "scheduler.py").write_text(
        "class RuntimeStats:\n    pass\n")
    found = lint.lint_metrics(str(tmp_path))
    assert _codes(found) == ["OBS002"] and "phantom" in found[0].message


def _krn_tree(tmp_path, kernels: str, not_ported: str = "{}"):
    """A source root with one Pallas module (two entry points at lines 1
    and 3), the port's ref.py, a wrapper module and a CUDA source."""
    jk = tmp_path / "src" / "repro" / "kernels"
    pk = tmp_path / "src" / "repro_torch" / "kernels"
    (pk / "csrc").mkdir(parents=True, exist_ok=True)
    jk.mkdir(parents=True, exist_ok=True)
    (jk / "mykern.py").write_text(
        "def my_kernel(x):\n"
        "    return pl.pallas_call(lambda r: r)(x)\n"
        "def other_kernel(x):\n"
        "    return pl.pallas_call(lambda r: r)(x)\n"
        "def helper(x):\n"
        "    return x\n")
    (pk / "ref.py").write_text("def my_ref(x):\n    return x\n")
    (pk / "wrap.py").write_text("def my_kernel(x):\n    return x\n")
    (pk / "csrc" / "my.cu").write_text("// kernel\n")
    (pk / "registry.py").write_text(
        f"KERNELS = {kernels}\nNOT_PORTED = {not_ported}\n")
    return str(tmp_path / "src")


_GOOD = ('{"my": {"wrapper": "wrap.my_kernel", "plain": "my_ref", '
         '"source": "src/repro_torch/kernels/csrc/my.cu", '
         '"jax_ref": "mykern.my_kernel", '
         '"replaces": "src/repro/kernels/mykern.py:1"}, '
         '"my_bwd": {"wrapper": "wrap.my_kernel", "plain": "my_ref", '
         '"source": "src/repro_torch/kernels/csrc/my.cu", "jax_ref": None, '
         '"replaces": None, "backward_of": "my"}}')


def test_lint_kernel_registry_clean_tree(tmp_path):
    root = _krn_tree(tmp_path, _GOOD,
                     '{"mykern.other_kernel": "waits for its slice"}')
    assert lint.lint_kernel_registry(root) == []


@pytest.mark.parametrize("change,needle", [
    (("csrc/my.cu", "csrc/gone.cu"), "is no file"),
    (('"plain": "my_ref", "source": "src/repro_torch/kernels/csrc/my.cu", '
      '"jax_ref": "mykern', '"plain": "no_ref", "source": '
      '"src/repro_torch/kernels/csrc/my.cu", "jax_ref": "mykern'),
     "not a function in kernels/ref.py"),
    (('"wrap.my_kernel", "plain": "my_ref", "source": "src/repro_torch/'
      'kernels/csrc/my.cu", "jax_ref": "mykern',
      '"wrap.gone", "plain": "my_ref", "source": "src/repro_torch/'
      'kernels/csrc/my.cu", "jax_ref": "mykern'), "names no function"),
    (("mykern.py:1", "mykern.py:6"), "no function builds a pl.pallas_call"),
    (("mykern.py:1", "mykern.py:4"), "is not the Pallas entry point"),
    (('"backward_of": "my"', '"backward_of": "nothing"'),
     "names no forward"),
])
def test_lint_kernel_registry_catches(tmp_path, change, needle):
    bad = _GOOD.replace(*change)
    assert bad != _GOOD
    root = _krn_tree(tmp_path, bad, '{"mykern.other_kernel": "later"}')
    msgs = [f.message for f in lint.lint_kernel_registry(root)]
    assert any(needle in m for m in msgs), msgs
    assert all(f.code == "KRN001"
               for f in lint.lint_kernel_registry(root))


def test_lint_kernel_registry_coverage_and_stale_keys(tmp_path):
    # other_kernel neither ported nor listed; a stale NOT_PORTED key
    root = _krn_tree(tmp_path, _GOOD, '{"mykern.gone": "later"}')
    msgs = [f.message for f in lint.lint_kernel_registry(root)]
    assert any("'mykern.other_kernel' has no KERNELS entry" in m
               for m in msgs)
    assert any("'mykern.gone'" in m and "stale" in m for m in msgs)
    root = _krn_tree(tmp_path, _GOOD, '{"mykern.my_kernel": "x", '
                     '"mykern.other_kernel": "y"}')
    msgs = [f.message for f in lint.lint_kernel_registry(root)]
    assert any("'mykern.my_kernel' has a KERNELS entry" in m for m in msgs)


# ---------------------------------------------------------------------------
# the plan verifier
# ---------------------------------------------------------------------------

def test_verify_matches_jax(capsys):
    assert verify.run(["--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert jax_verify.run() == 0
    want = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("ok   Q") for line in got) == 12
    assert got == want


# ---------------------------------------------------------------------------
# the examples and chip_smoke.py's phase 13, at a tiny size on the CPU
# ---------------------------------------------------------------------------

def _example(name):
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        return __import__(name)
    finally:
        sys.path.remove(str(ROOT / "examples"))


@pytest.mark.parametrize("name,argv,expect", [
    ("torch_quickstart", ["--device", "cpu"], "max TMAX ="),
    ("torch_serve_lm", ["--device", "cpu", "--requests", "2", "--gen", "3"],
     "generated 2 x 3 tokens"),
    ("torch_train_lm", ["--device", "cpu", "--steps", "4"],
     "=== done: 2 post-resume steps"),
])
def test_example_runs_on_cpu(name, argv, expect, capsys):
    _example(name).main(argv)
    assert expect in capsys.readouterr().out


def test_chip_smoke_tooling_path_rehearsal_on_cpu():
    """Phase 13 on the CPU at the smoke size: verify and lint, the dry run
    of phase 9's cell (its argument bytes against the built tensors'),
    the "dots" vs "full" routes in float32, two steps under "dots"."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    dev = torch.device("cpu")
    out = chip_smoke.tooling_path(
        dev, smoke=True, cells=[], budget=2**30, jobs=1, steps=2, batch=2,
        seq=64, route_batch=2, overrides={"head_dim": 64, "remat": True})
    assert out["arguments"]["rel_err"] == 0.0
    r = out["routes"]
    assert r["loss"]["dots"] == r["loss"]["full"]
    assert r["grad_leaf_rel_err"] == 0.0
    assert out["dots"]["remat_policy"] == "dots"
    peaks = out["compare"]["peaks"]
    assert peaks["dots"]["estimated_mib"] > peaks["full"]["estimated_mib"]
