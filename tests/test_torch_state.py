"""State of the PyTorch port: the database carried across from the JAX
package, the port's own ingest, the device default, and the rule that
the port imports nothing of JAX or of the JAX package."""
import ast
import dataclasses
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.data.weather import WeatherSpec as JaxSpec
from repro.data.weather import build_database as jax_build
from repro_torch.core import Executor, xdm
from repro_torch.data.weather import WeatherSpec, build_database

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def assert_same_database(a, b):
    """Two databases (either package) hold the same dictionaries, node
    tables and statistics."""
    assert [a.names.str(i) for i in range(len(a.names))] == \
        [b.names.str(i) for i in range(len(b.names))]
    assert [a.strings.str(i) for i in range(len(a.strings))] == \
        [b.strings.str(i) for i in range(len(b.strings))]
    assert list(a.collections) == list(b.collections)
    for name in a.collections:
        pa, pb = a.collections[name].partitions, b.collections[name].partitions
        assert len(pa) == len(pb)
        for ta, tb in zip(pa, pb):
            for k in xdm.NODE_ARRAYS:
                va, vb = getattr(ta, k), getattr(tb, k)
                if k == "multi":
                    assert va.keys() == vb.keys()
                    for m in va:
                        np.testing.assert_array_equal(va[m], vb[m])
                else:
                    assert va.dtype == vb.dtype, (name, k)
                    np.testing.assert_array_equal(va, vb)
        sa, sb = a.stats[name], b.stats[name]
        assert (sa.max_nodes, sa.tag_max, sa.tag_distinct) == \
            (sb.max_nodes, sb.tag_max, sb.tag_distinct)


def test_carry_over_round_trip(weather_db):
    port_db = xdm.database_from_arrays(*xdm.database_to_arrays(weather_db))
    assert_same_database(port_db, weather_db)
    again = xdm.database_from_arrays(*xdm.database_to_arrays(port_db))
    assert_same_database(again, port_db)


def test_carry_over_rejects_incomplete_partition(weather_db):
    names, strings, colls = xdm.database_to_arrays(weather_db)
    del colls["/stations"][0]["field_map"]
    with pytest.raises(ValueError, match="field_map"):
        xdm.database_from_arrays(names, strings, colls)


@pytest.mark.parametrize("sax", [False, True])
def test_port_ingest_matches_reference(sax):
    kw = dict(num_stations=5, years=(1976, 2000), days_per_year=2)
    assert_same_database(build_database(WeatherSpec(**kw), 2, sax=sax),
                         jax_build(JaxSpec(**kw), 2, sax=sax))


def test_executor_defaults_to_cuda(monkeypatch):
    db = build_database(WeatherSpec(num_stations=3, years=(2000,),
                                    days_per_year=2), 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Executor(db)
    assert Executor(db, device="cpu").device.type == "cpu"


def test_import_leaves_out_jax_and_reference():
    """Importing every module of the port, and chip_smoke.py, loads no
    jax* and no repro/repro.* module (fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__,\n"
        "                               'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_reference_imports_in_source():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for sub in ("models", "configs", "launch", "kernels", "core", "optim",
                "checkpoint", "runtime", "data"):
        assert any(f.parent.name == sub for f in files), sub
    for new in ("launch/mesh.py", "launch/xquery_cluster.py",
                "core/baselines/__init__.py", "core/baselines/saxon_like.py",
                "core/baselines/mrql_like.py", "core/persist.py",
                "optim/__init__.py", "optim/adamw.py", "optim/schedule.py",
                "checkpoint/__init__.py", "checkpoint/manager.py",
                "runtime/__init__.py", "runtime/straggler.py",
                "runtime/elastic.py", "runtime/compression.py",
                "data/pipeline.py", "models/flops.py", "launch/train.py",
                "models/moe.py", "models/ssm.py", "launch/fsdp.py",
                "sharding.py"):
        assert PORT / new in files, new
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)


def test_chip_smoke_main_path_rehearsal_on_cpu():
    """chip_smoke.py's main-path phase, at a tiny scale on the CPU (the
    plain versions stand in for the kernels): presized caps, kernel
    route vs plain route, and the numpy reference from the records."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    spec = WeatherSpec(num_stations=12, years=(1976, 1999, 2000, 2001, 2003),
                       days_per_year=3)
    ex = Executor(build_database(spec, 4), device="cpu")
    from repro_torch.kernels import ops
    capture = chip_smoke.Capture(ops)
    recs = chip_smoke.main_path(ex, spec, capture)
    assert [r["query"] for r in recs] == [f"Q{i}" for i in range(1, 13)]
    assert all(r["rows"] > 0 for r in recs)
    # the CPU joins take the sorted-hash route, not the kernel entry point
    assert set(capture.best) == {"segmented_aggregate", "segment_topk"}
    assert len(capture.agg_calls) == 4          # Q9-Q12, phase 4's inputs
    assert all(r["join_table_mib"] == 0.0 for r in recs)


@pytest.mark.parametrize("kind,share", [("runs", (0.1, 0.3)),
                                        ("hot", (0.8, 1.0)),
                                        ("sparse", (0.003, 0.005)),
                                        ("none", (0.0, 0.0))])
def test_chip_smoke_aggregate_edge_inputs_on_cpu(kind, share):
    """chip_smoke.py's aggregate edge inputs (phase 2) on the CPU: the
    station-major runs cross the 4096-row tiles, the hot case puts every
    valid row of [0, S) in segment 0, the sparse case keeps 0.4 % of the
    rows in clusters; the plain version accepts them."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import ref
    vals, ok, segs, valid, s = chip_smoke.agg_inputs(2, 10007, 50, 3, 1,
                                                     "cpu", kind)
    assert vals.shape == (2, 10007, 3) and segs.dtype == torch.int32
    lo, hi = share
    assert lo <= float(valid.float().mean()) <= hi
    kept = segs[valid & (segs >= 0) & (segs < s)]
    if kind == "hot":
        assert kept.numel() > 0 and bool((kept == 0).all())
    if kind == "runs":
        # 97-row runs of one id: a run spans the tile boundary at 4096
        assert bool((segs[:, 4095] == segs[:, 4096]).all())
    counts = ref.segmented_aggregate(vals, ok, segs, valid, s)[0]
    assert int(counts.sum()) == kept.numel()


def test_chip_smoke_lm_path_rehearsal_on_cpu():
    """chip_smoke.py's phase 5 at the smoke size of qwen3-1.7b on the
    CPU: kernel route cold and warm, the plain route teacher-forced, the
    logits compared (the plain versions stand in for the kernels)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    out = chip_smoke.lm_path(torch.device("cpu"), smoke=True, requests=2,
                             prompt_len=16, gen_len=3)
    assert out["generated_shape"] == [2, 3]
    assert max(out["logit_max_abs_err"].values()) <= chip_smoke.LOGIT_ATOL
    assert out["plain_argmax_agrees"] == 1.0
    assert out["cold_warm_tokens_equal"]


def test_chip_smoke_dense_path_rehearsal_on_cpu():
    """chip_smoke.py's phase 15 at the smoke sizes of llama3-8b,
    gemma2-9b and gemma3-12b on the CPU: the weights drawn in the
    compute dtype, the serve cold and warm on the kernel route (the
    plain versions stand in for the kernels), the plain route in bf16
    and the float32 gate at one pattern period; ``LastCall`` keeps the
    last windowed and the last global call of each kernel for gemma
    (whose windows of 8 cut the 16-token prompts) and one of each for
    llama3; the library column: ``flex_attention`` (eager here) where
    a window or a softcap is on, else ``scaled_dot_product_attention``,
    each giving the plain attention's output."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.models import attention
    dev = torch.device("cpu")
    for arch in chip_smoke.DENSE_ARCHS:
        cfg = get_smoke_config(arch)
        last = chip_smoke.LastCall(ops)
        out = chip_smoke.dense_path(dev, arch, smoke=True, requests=2,
                                    prompt_len=16, gen_len=3,
                                    f32_layers=cfg.period, capture=last)
        assert out["params"] == cfg.num_params()
        f32 = out["float32"]
        assert max(f32["logit_max_abs_err"].values()) \
            <= chip_smoke.DENSE_F32_LOGIT_ATOL[arch]
        assert f32["plain_argmax_agrees"] == 1.0
        assert 0.0 <= out["bfloat16"]["plain_argmax_agrees"] <= 1.0
        calls = chip_smoke.dense_calls(arch, cfg, last)
        assert [f[1]["window"] for _, f, _ in calls] == \
            ([8, None] if cfg.window else [None])
        for where, fcall, dcall in calls:
            (q, k, v), fkw = fcall
            (dq, kc, vc, kv_len), dkw = dcall
            assert fkw["window"] == dkw["window"]
            assert fkw["logit_softcap"] == dkw["logit_softcap"] == (
                cfg.attn_logit_softcap or None)
            flib, fname = chip_smoke.flash_library(fcall)
            dlib, dname = chip_smoke.decode_library(dcall)
            masked = fkw["window"] or fkw["logit_softcap"]
            assert fname == dname == ("flex_attention" if masked else
                                      "scaled_dot_product_attention")
            want = attention.dense_attention(
                q, k, v, window=fkw["window"],
                logit_softcap=fkw["logit_softcap"])
            torch.testing.assert_close(flib().transpose(1, 2), want,
                                       atol=2e-2, rtol=2e-2)
            want = attention.decode_attention(
                dq, kc, vc, kv_len=kv_len, window=dkw["window"],
                logit_softcap=dkw["logit_softcap"])
            torch.testing.assert_close(dlib().transpose(1, 2), want,
                                       atol=2e-2, rtol=2e-2)


class _CountCalls:
    """Counts the calls of one ``kernels.ops`` attention entry point, in
    all and by ``window``, as its kernel's wrapper counts its launches on
    the card (``launches``, ``by_window``): on the CPU the wrappers run
    the plain versions and count nothing."""

    def __init__(self, monkeypatch, ops, name):
        self.launches, self.by_window = 0, {}
        fn = getattr(ops, name)

        def counted(*args, **kw):
            self.launches += 1
            w = kw.get("window")
            self.by_window[w] = self.by_window.get(w, 0) + 1
            return fn(*args, **kw)

        monkeypatch.setattr(ops, name, counted)


def test_chip_smoke_moe_serve_path_rehearsal_on_cpu(monkeypatch):
    """chip_smoke.py's phase 16 at the smoke sizes of llama4-scout (its
    group of 5 query heads a kv head: 10/2 heads) and jamba on the CPU:
    the serve cold and warm with the calls the kernels would launch
    counted by window, the tokens and expert ids of both equal; the plain
    route in bf16 with its share of differing routing decisions; the
    float32 gate with the plain route routed as the kernel route
    (``RouteReplay``); ``moe_f64_check`` on the first MoE layer (jamba's
    layer 1); and the library column (SDPA with ``enable_gqa``) against
    the plain attention on the calls the serve made. At the published
    configs and phase 16's depths the serve launches the flash kernel 12
    and 2 times, and the decode kernel 384 and 64 times."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.models import attention
    dev = torch.device("cpu")
    full = {"llama4-scout-17b-a16e": (12, 384), "jamba-v0.1-52b": (2, 64)}
    heads = {"llama4-scout-17b-a16e": {"num_heads": 10, "num_kv_heads": 2},
             "jamba-v0.1-52b": {}}
    for arch in chip_smoke.MOE_WIDE_ARCHS:
        cut = dataclasses.replace(
            get_config(arch), num_layers=chip_smoke.MOE_WIDE_LAYERS[arch])
        assert chip_smoke.window_launches(cut, chip_smoke.LM_GEN) == {
            "flash_attention": {None: full[arch][0]},
            "decode_attention": {None: full[arch][1]}}
        counters = {n: _CountCalls(monkeypatch, ops, n)
                    for n in chip_smoke.LastCall.NAMES}
        cfg = dataclasses.replace(get_smoke_config(arch), **heads[arch])
        last = chip_smoke.LastCall(ops)
        out = chip_smoke.moe_wide_path(
            dev, arch, smoke=True, requests=2, prompt_len=16, gen_len=3,
            overrides=heads[arch], f32_layers=cfg.period, f64_tokens=64,
            counters=counters, capture=last)
        assert out["params"] == cfg.num_params()
        assert out["layers"] == out["cfg"].num_layers == cfg.num_layers
        assert out["by_window"] == chip_smoke.window_launches(cfg, 3)
        n_attn = sum(cfg.layer_spec(i).mixer == "attn"
                     for i in range(cfg.num_layers))
        assert out["warm"]["launches"] == {"flash_attention": n_attn,
                                           "decode_attention": 3 * n_attn}
        assert out["cold_warm_tokens_equal"]
        assert 0.0 <= out["bfloat16"]["routing_decisions_differ"] <= 1.0
        f32 = out["float32"]
        assert f32["routes_replayed"]
        assert f32["routing_decisions_differ"] == 0.0
        assert max(f32["logit_max_abs_err"].values()) \
            <= chip_smoke.MOE_WIDE_F32_LOGIT_ATOL[arch]
        assert f32["plain_argmax_agrees"] == 1.0
        f64 = out["float64"]
        assert all(f64["equal"].values())
        assert f64["layer"] == (1 if arch == "jamba-v0.1-52b" else 0)
        assert f64["top_k"] == cfg.top_k
        rows = chip_smoke.dense_calls(arch, out["cfg"], last)
        assert len(rows) == 1
        _, fcall, dcall = rows[0]
        (q, k, v), fkw = fcall
        (dq, kc, vc, kv_len), dkw = dcall
        assert q.shape[2] // k.shape[2] == cfg.num_heads // cfg.num_kv_heads
        flib, fname = chip_smoke.flash_library(fcall)
        dlib, dname = chip_smoke.decode_library(dcall)
        assert fname == dname == "scaled_dot_product_attention"
        torch.testing.assert_close(flib().transpose(1, 2),
                                   attention.dense_attention(q, k, v),
                                   atol=2e-2, rtol=2e-2)
        torch.testing.assert_close(
            dlib().transpose(1, 2),
            attention.decode_attention(dq, kc, vc, kv_len=kv_len),
            atol=2e-2, rtol=2e-2)
        monkeypatch.undo()


def test_chip_smoke_tp_layer_path_rehearsal_on_cpu(monkeypatch):
    """chip_smoke.py's phase 17 at the smoke sizes of llama3-8b and
    gemma3-12b (window 8 over 16 positions, qk-norm, post-norms) with
    8/4 heads, so that its 4 ranks divide them, on the CPU's plain
    attention route, and of jamba-v0.1-52b and mamba2-370m, whose first
    layer is a Mamba-2 mixer (8 heads of 16, 2 a rank; jamba's with a
    dense MLP): the layer split four ways, each rank's share in turn,
    agrees with the whole layer in float32 and bfloat16 within TP_TOL on
    its output, its input gradient and every weight gradient, and the
    kernel entry point is never called. At the published configs the
    first layer splits too: 8/2 and 4/2 heads a rank, 32 and 8 SSD heads
    a rank. Then
    phase 17's vocabulary lines at the smoke sizes of llama3-8b (its own
    lm_head) and gemma2-9b (tied, final softcap 30): the lookup's rows
    equal the whole table's bit for bit, and the loss, its input
    gradient, the table's gradient and the lookup's table gradient agree
    within TP_TOL in float32 and bfloat16; the published vocabularies
    (128256, 256000) split over the 4 ranks."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.launch import fsdp
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.sharding import MeshShape
    from repro_torch.kernels import ops
    m = chip_smoke.TP_RANKS
    for arch in chip_smoke.TP_ARCHS:
        full = get_config(arch)
        specs = mesh_lib.param_specs(full, MeshShape((1, m),
                                                     ("data", "model")))
        want = chip_smoke.tp_sublayers(full.layer_spec(0))
        assert want == {"jamba-v0.1-52b": ("mamba", "mlp"),
                        "mamba2-370m": ("mamba",)}.get(arch, ("attn", "mlp"))
        assert fsdp.split_sublayers(full, specs["layers"][0], m) == want
        counters = {"flash_attention": _CountCalls(monkeypatch, ops,
                                                   "flash_attention")}
        out = chip_smoke.tp_layer_path(
            torch.device("cpu"), arch, smoke=True, batch=2, seq=16,
            overrides={"num_heads": 8, "num_kv_heads": 4},
            counters=counters)
        mixer = "mamba" if "mamba" in want else "attn"
        assert out["ranks"] == m and out["mixer"].startswith(mixer)
        assert out["heads"] == ([8, 4] if mixer == "attn" else None)
        assert out["qk_norm"] == (arch == "gemma3-12b")
        if mixer == "mamba":
            assert (out["d_inner"], out["ssm_heads"]) == (128, 8)
        leaves = {"attn": {"attn/wq", "attn/wo"},
                  "mamba": {"mamba/wz", "mamba/wx", "mamba/wB", "mamba/wC",
                            "mamba/wdt", "mamba/conv_w", "mamba/conv_b",
                            "mamba/dt_bias", "mamba/a_log", "mamba/D",
                            "mamba/norm/scale", "mamba/wo"}}[mixer]
        if "mlp" in want:
            leaves |= {"mlp/wi_gate", "mlp/wo"}
        for dtype, tol in chip_smoke.TP_TOL.items():
            rec = out[dtype]
            assert rec["finite"] and rec["worst"] <= tol
            assert {"out", "x", "ln_mixer/scale"} | leaves \
                <= set(rec["max_rel_err"])
            assert ("attn/q_norm/scale" in rec["max_rel_err"]) \
                == (arch == "gemma3-12b")
            assert rec["launches_split"] == rec["launches_whole"] == {
                "flash_attention": 0}
        assert "ms" not in out
        monkeypatch.undo()
    for arch in chip_smoke.TP_VOCAB_ARCHS:
        full = get_config(arch)
        specs = mesh_lib.param_specs(full, MeshShape((1, m),
                                                     ("data", "model")))
        assert fsdp.vocab_splits(specs, m)
        out = chip_smoke.tp_vocab_path(torch.device("cpu"), arch,
                                       smoke=True, batch=2, seq=16)
        assert out["ranks"] == m and out["vocab"] == 128
        assert out["tied"] == (arch == "gemma2-9b")
        assert out["final_softcap"] == (full.final_logit_softcap or None)
        assert 0 < out["labeled"] < 32
        for dtype, tol in chip_smoke.TP_TOL.items():
            rec = out[dtype]
            assert rec["finite"] and rec["lookup_equal"]
            assert rec["worst"] <= tol
            assert set(rec["max_rel_err"]) == {"lookup_table", "loss", "x",
                                               "table"}
        assert "ms" not in out and "peak_mib" not in out


def test_chip_smoke_route_replay_on_cpu():
    """``RouteReplay`` routes a MoE layer to the expert ids a
    ``RouteLog`` recorded: the ids it was given, with the call's own
    probabilities at them as gates, the package's ranks and dispatch; the
    layer's own ids give its output and aux bit for bit, and ``own``
    holds the ids its own router chose."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model, moe
    for arch in chip_smoke.MOE_WIDE_ARCHS:
        cfg = get_smoke_config(arch)
        first = next(i for i in range(cfg.num_layers)
                     if cfg.layer_spec(i).mlp == "moe")
        p = model.init_params(cfg, 3, "cpu")["layers"][first]["moe"]
        x = torch.from_numpy(np.random.default_rng(4).normal(
            size=(40, cfg.d_model)).astype(np.float32))
        kw = dict(top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                  act=cfg.act)
        with chip_smoke.RouteLog() as log:
            want = moe.moe_apply(p, x, **kw)
        with chip_smoke.RouteReplay(log.ids) as rep:
            got = moe.moe_apply(p, x, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(rep.own[0], log.ids[0])
        # other experts: the given ids, each token's first one moved on
        other = log.ids[0].clone()
        other[:, 0] = (other[:, 0] + 1) % cfg.num_experts
        if cfg.top_k > 1:
            clash = other[:, 0] == other[:, 1]
            other[clash, 1] = (other[clash, 1] + 1) % cfg.num_experts
        with chip_smoke.RouteReplay([other]) as rep:
            r = moe.route(p, x, top_k=cfg.top_k,
                          capacity_factor=cfg.capacity_factor)
        assert moe.route is rep.saved and moe.torch is torch
        assert torch.equal(r["expert_ids"], other)
        probs = torch.softmax(x @ p["router"], -1).gather(-1, other)
        torch.testing.assert_close(r["gate"], probs / probs.sum(-1, True))
        assert torch.equal(rep.own[0], log.ids[0])
        assert chip_smoke.route_share(rep.own, [other]) == 1.0
        want = moe.route(p, x, top_k=cfg.top_k)
        assert torch.equal(want["expert_ids"], log.ids[0])


TINY_SPEC = dict(num_stations=12, years=(1976, 1999, 2000, 2001, 2003),
                 days_per_year=3)


def test_chip_smoke_spmd_path_rehearsal_on_cpu():
    """chip_smoke.py's phase 7 at a tiny scale on the CPU: the database
    with P = 1, Q1–Q12 in spmd mode over an in-process gloo group of one
    rank (NCCL on the card), both routes and join strategies, the
    service cold and warm, the numpy reference and sim mode's raw
    dicts; the group is destroyed afterwards."""
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import hash_join, ops
    spec = WeatherSpec(**TINY_SPEC)
    counters = {"block_join_probe": hash_join.block_join_probe}
    capture = chip_smoke.Capture(ops)
    out = chip_smoke.spmd_path(spec, torch.device("cpu"), "gloo", counters,
                               capture=capture)
    assert not dist.is_initialized()
    # P = 1 inputs of the segment entry points, for the kernel timings
    assert set(capture.best) == {"segmented_aggregate", "segment_topk"}
    assert all(a[0].shape[0] == 1 for a in capture.agg_calls)
    recs = out["queries"]
    assert [r["query"] for r in recs] == [f"Q{i}" for i in range(1, 13)]
    assert all(r["rows"] > 0 and r["gathered_bytes"] > 0 for r in recs)
    assert all("repartition_warm_ms" in r for r in recs[4:8])
    assert out["service_compiles"] == 12
    # the CPU joins take the sorted-hash route
    assert out["launches"] == {"block_join_probe": 0}


def test_chip_smoke_mrql_path_rehearsal_on_cpu():
    """chip_smoke.py's phase 8 at a tiny scale on the CPU: MrqlLike on
    Q1–Q12 against the numpy reference, beside given service times."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    spec = WeatherSpec(**TINY_SPEC)
    recs = chip_smoke.mrql_path(build_database(spec, 4), spec,
                                torch.device("cpu"),
                                {f"Q{i}": 1.0 for i in range(1, 13)})
    assert [r["query"] for r in recs] == [f"Q{i}" for i in range(1, 13)]
    assert [r["jobs"] for r in recs] == [1, 1, 2, 2, 3, 3, 4, 4, 2, 2, 3, 2]
    assert all(r["mrql_over_service"] == r["ms"] for r in recs)


def test_chip_smoke_train_path_rehearsal_on_cpu():
    """chip_smoke.py's phase 9 at the smoke size of qwen3-1.7b on the
    CPU: kernel-route vs plain-route gradients (the autograd function
    with the plain forward and backward standing in for the kernels),
    ``launch.train.train`` for two steps with the per-step records, and
    the checkpoint resume against the uninterrupted run."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    dev = torch.device("cpu")
    out = chip_smoke.train_path(dev, smoke=True, steps=2, batch=2, seq=16)
    routes = out["routes"]
    assert routes["zero_grad_leaves"] == [] and routes["leaves"] > 10
    assert routes["grad_leaf_rel_err"] <= chip_smoke.TRAIN_GRAD_TOL
    assert len(out["losses"]) == 2 and out["microbatches"] == 2
    assert out["tokens_per_s"] > 0 and out["model_flops"] > 0
    rec = chip_smoke.resume_check(dev)
    assert rec["max_abs_err"] <= chip_smoke.RESUME_ATOL
    assert len(rec["losses"]) == 8 and len(rec["resumed_losses"]) == 4


def test_chip_smoke_moe_path_rehearsal_on_cpu():
    """chip_smoke.py's phase 10 at the smoke size of granite-moe-1b-a400m
    on the CPU: serve cold and warm, the plain route teacher-forced in
    bf16 (printed) and in float32 (gated), the routing logs, one MoE
    layer in float64 (both sides on the CPU here), the float32 training
    routes and two training steps."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    out = chip_smoke.moe_path(torch.device("cpu"), smoke=True, requests=2,
                              prompt_len=16, gen_len=3, steps=2, batch=2,
                              seq=16, f64_tokens=64)
    assert out["float32"]["logit_max_abs_err"]["step_logits"] \
        <= chip_smoke.MOE_F32_LOGIT_ATOL
    assert 0.0 <= out["bfloat16"]["routing_decisions_differ"] <= 1.0
    assert out["float32"]["routing_decisions_differ"] == 0.0
    assert all(out["float64"]["equal"].values())
    assert out["float64"]["kept"] <= out["float64"]["assignments"]
    routes = out["train"]["routes"]
    assert routes["compute_dtype"] == "float32"
    assert routes["zero_grad_leaves"] == []
    assert all(a > 0 for a in routes["moe_aux"].values())
    assert len(out["train"]["losses"]) == 2


def test_chip_smoke_ssm_path_rehearsal_on_cpu():
    """chip_smoke.py's phase 11 at the smoke size of mamba2-370m on the
    CPU: serve cold and warm with no attention, the forward against the
    prefill and decode chain in float32 and bf16, four training steps
    with finite losses, and four steps on one fixed batch whose loss
    falls."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    out = chip_smoke.ssm_path(torch.device("cpu"), smoke=True, requests=2,
                              prompt_len=16, gen_len=3, batch=2, seq=16)
    chain = out["chain"]
    assert chain["float32"]["forward"] == 24       # 16 + one chunk of 8
    assert chain["float32"]["max_abs_err"] <= chip_smoke.SSM_CHAIN_ATOL
    assert chain["bfloat16"]["max_abs_err"] > 0
    assert out["train"]["routes"] is None
    assert len(out["train"]["losses"]) == 4
    assert all(math.isfinite(x) for x in out["train"]["losses"])
    assert out["fit"][-1] < out["fit"][0]


def test_chip_smoke_frontend_paths_rehearsal_on_cpu():
    """chip_smoke.py's phase 12 at the smoke sizes of qwen2-vl-2b and
    hubert-xlarge on the CPU: the patches batch prefilled and decoded
    cold and warm through the serve steps, the kernel route against the
    plain route teacher-forced in bf16 and float32; the frames forward
    cold and warm and its routes; the float32 training routes (hubert's
    token table, which its forward never reads, with no gradient) and
    two training steps of each, with the configs' microbatches."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    dev = torch.device("cpu")
    vlm = chip_smoke.vlm_path(dev, smoke=True, batch=2, seq=16, gen_len=3,
                              steps=2)
    assert vlm["warm"]["patches"] == 4 and vlm["warm"]["tokens"] == 12
    assert vlm["bfloat16"]["kernel_argmax_is_fed"] == 1.0
    assert max(vlm["float32"]["logit_max_abs_err"].values()) \
        <= chip_smoke.VLM_F32_LOGIT_ATOL
    assert vlm["train"]["microbatches"] == 2
    assert vlm["train"]["routes"]["unused_leaves"] == []
    audio = chip_smoke.audio_path(dev, smoke=True, batch=4, seq=16, steps=2)
    assert audio["routes"]["float32"]["logit_max_abs_err"] \
        <= chip_smoke.AUDIO_F32_LOGIT_ATOL
    assert audio["train"]["microbatches"] == 4
    routes = audio["train"]["routes"]
    assert routes["unused_leaves"] == ["embed"]
    assert routes["zero_grad_leaves"] == []
    for out in (vlm, audio):
        assert len(out["train"]["losses"]) == 2
        assert all(math.isfinite(x) for x in out["train"]["losses"])
