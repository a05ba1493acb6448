"""The executor of the PyTorch port (device="cpu") against the JAX
``Executor`` on the same data: Q1–Q12 on a database carried across
from the ``weather_db`` fixture must pass ``check_result`` against the
SaxonLike oracle, and their raw-output dicts must match the JAX ones.

Raw-dict parity: ``valid`` and every overflow flag exactly; every
``var*`` at valid slots exactly, except the float columns that come
from a sum, an average or a division, held to rtol=1e-5 (XLA may turn
a division by a constant into a multiply by its reciprocal, and sums
run in another order).
"""
import numpy as np
import pytest
from conftest import check_result

from repro.core import ExecConfig as JaxConfig
from repro.core import Executor as JaxExecutor
from repro.core import compile_query as jax_compile
from repro.core.queries import ALL, JOINS
from repro_torch.core import ExecConfig, Executor, compile_query, xdm
from repro_torch.core.executor import OVERFLOW_FLAGS

RTOL = 1e-5
# result positions (in DistributeResult order) that are sums, averages
# or divisions
TOLERANT = {"Q3": {0}, "Q4": {0}, "Q7": {0}, "Q8": {0}, "Q9": {2},
            "Q10": {1}, "Q11": {2}, "Q12": {2}}
KNOB_SENSITIVE = ("Q5", "Q6", "Q7", "Q8", "Q9", "Q10", "Q11", "Q12")


@pytest.fixture(scope="module")
def jax_runs(weather_db):
    """JAX raw dicts, one run per (query, config), shared by the tests."""
    ex = JaxExecutor(weather_db)      # interns the derived strings first
    cache = {}

    def run(name, **cfg):
        cfg = {k: v for k, v in cfg.items() if v is not None}  # defaults
        key = (name, tuple(sorted(cfg.items())))
        if key not in cache:
            cache[key] = ex.run(jax_compile(ALL[name]),
                                config=JaxConfig(**cfg)).raw
        return cache[key]

    return run


@pytest.fixture(scope="module")
def port(jax_runs, weather_db):
    db = xdm.database_from_arrays(*xdm.database_to_arrays(weather_db))
    return Executor(db, device="cpu")


def assert_raw_equal(got: dict, want: dict, name: str, plan):
    assert set(got) == set(want) - {"prof_rows"}, (set(got), set(want))
    valid = np.asarray(want["valid"])
    np.testing.assert_array_equal(got["valid"], valid)
    for flag in ("overflow",) + tuple(OVERFLOW_FLAGS.values()):
        np.testing.assert_array_equal(got[flag], np.asarray(want[flag]),
                                      err_msg=flag)
    for pos, v in enumerate(plan.vars):
        g, w = got[f"var{v}"], want[f"var{v}"]
        parts = zip(g, w) if isinstance(w, tuple) else [(g, w)]
        for gp, wp in parts:
            gp, wp = np.asarray(gp), np.asarray(wp)
            assert gp.shape == wp.shape and gp.dtype == wp.dtype, (
                name, v, gp.shape, wp.shape, gp.dtype, wp.dtype)
            gv, wv = gp[valid], wp[valid]
            if gp.dtype == np.float32 and pos in TOLERANT.get(name, ()):
                np.testing.assert_allclose(gv, wv, rtol=RTOL,
                                           err_msg=f"{name} var{v}")
            else:
                np.testing.assert_array_equal(gv, wv,
                                              err_msg=f"{name} var{v}")


def run_both(port, jax_runs, name, port_knobs=None, **cfg):
    """Run ``name`` on the port with ``cfg`` (plus ``port_knobs``) and
    hold its raw dict against the JAX run with ``cfg``."""
    plan = compile_query(ALL[name])
    rs = port.run(plan, config=ExecConfig(**cfg, **(port_knobs or {})))
    assert_raw_equal(rs.raw, jax_runs(name, **cfg), name, plan)
    return rs


@pytest.mark.parametrize("name", list(ALL))
def test_port_default_route(port, jax_runs, oracle, name):
    rs = run_both(port, jax_runs, name)
    assert not rs.overflow
    check_result(rs, oracle, name)


@pytest.mark.parametrize("name", JOINS)
def test_port_repartition_join(port, jax_runs, oracle, name):
    rs = run_both(port, jax_runs, name, join_strategy="repartition")
    assert not rs.overflow
    check_result(rs, oracle, name)


@pytest.mark.parametrize("name", KNOB_SENSITIVE)
def test_port_kernel_knobs_flipped(port, jax_runs, oracle, name):
    """The CPU default is join knob False, segment knob True; here both
    flip (the join entry point's plain version, the legacy group-by).
    The JAX package holds its own knob routes to one result
    (tests/test_queries.py, tests/test_groupby.py), so its default run
    is the reference for either setting."""
    rs = run_both(port, jax_runs, name,
                  port_knobs={"use_kernel_join": True,
                              "use_kernel_segments": False})
    assert rs.overflow is False
    check_result(rs, oracle, name)


@pytest.mark.parametrize("name,cfg,flag", [
    ("Q2", {"scan_cap": 8}, "overflow_scan"),
    ("Q6", {"join_cap": 1}, "overflow_join_cap"),
    ("Q9", {"group_cap": 2}, "overflow_group_cap"),
    ("Q11", {"topk_cap": 2}, "overflow_topk_cap"),
])
def test_port_overflow_flags(port, jax_runs, name, cfg, flag):
    rs = run_both(port, jax_runs, name, **cfg)
    assert rs.overflow and getattr(rs, flag)


@pytest.mark.parametrize("topk_cap,fused", [(4, True), (None, False)])
def test_port_q11_topk_routes(port, jax_runs, oracle, topk_cap, fused):
    rs = run_both(port, jax_runs, "Q11", topk_cap=topk_cap)
    assert not rs.overflow
    check_result(rs, oracle, "Q11")
    cp = port.compile(compile_query(ALL["Q11"]),
                      config=ExecConfig(topk_cap=topk_cap))
    assert cp.config.use_kernel_segments is fused
    # the ranking itself, in order, not only as a set
    want = port.run(compile_query(ALL["Q11"])).rows()
    assert rs.rows() == want


def test_port_later_slices_raise(port):
    """SPMD mode, AOT and donation wait for later slices; prepared,
    batched and profile compiles are ported (a batch without parameters
    is refused, as in the JAX package)."""
    plan = compile_query(ALL["Q1"])
    for kw in ({"mode": "spmd"}, {"aot": True}, {"donate": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            port.compile(plan, **kw)
    with pytest.raises(ValueError, match="needs parameters"):
        port.compile(plan, batch=2)
    assert port.run_compiled(port.compile(plan, profile=True)).op_rows()


@pytest.fixture(scope="module")
def jax_service(weather_db):
    from repro.core import QueryService
    return QueryService(weather_db)


@pytest.mark.parametrize("name", list(ALL))
def test_presized_caps_match_reference_service(port, jax_service, oracle,
                                               name):
    """``presize.presized_config`` gives the caps the JAX serving tier
    presizes with, and Q1–Q12 run exact and without overflow at them."""
    from repro_torch.core.presize import presized_config
    svc = jax_service
    plan = compile_query(ALL[name])
    got = presized_config(port.db, plan)
    want = svc._presized_config(jax_compile(ALL[name]))
    caps = ("scan_cap", "join_cap", "group_cap", "topk_cap")
    assert [getattr(got, c) for c in caps] == [getattr(want, c) for c in caps]
    rs = port.run(plan, config=got)
    assert not rs.overflow
    check_result(rs, oracle, name)


UNNEST_CHILD = '''
for $s in collection("/stations")/stationCollection/station
for $l in $s/locationLabels
where $l/type eq "ST"
return ($s/id, $l/displayName)
'''


@pytest.mark.parametrize("scan_cap", [None, 1])
def test_port_unnest_child(port, weather_db, scan_cap):
    """UNNEST over a repeated child (no query of Q1–Q12 has one): the
    scatter of context rows, the ancestor re-gather, and the unnest's
    own scan-cap overflow."""
    want = JaxExecutor(weather_db).run(jax_compile(UNNEST_CHILD),
                                       config=JaxConfig(scan_cap=scan_cap))
    plan = compile_query(UNNEST_CHILD)
    rs = port.run(plan, config=ExecConfig(scan_cap=scan_cap))
    assert_raw_equal(rs.raw, want.raw, "unnest", plan)
    assert rs.overflow_scan == (scan_cap is not None)
    if scan_cap is None:
        assert sorted(rs.rows()) == sorted(want.rows()) and rs.rows()
