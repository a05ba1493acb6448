"""State of the PyTorch port: the database carried across from the JAX
package, the port's own ingest, the device default, and the rule that
the port imports nothing of JAX or of the JAX package."""
import ast
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
    for sub in ("models", "configs", "launch", "kernels", "core"):
        assert any(f.parent.name == sub for f in files), sub
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
    assert all(r["join_table_mib"] == 0.0 for r in recs)


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
