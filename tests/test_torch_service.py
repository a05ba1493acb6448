"""The serving tier of the PyTorch port (``repro_torch.core.service``,
device="cpu") against the JAX package's ``QueryService`` on the same
data: Q1–Q12 results (``check_result`` and raw-dict parity), presized
configs, regrowth ladders, operator profiles, the admission runtime,
and the host-only modules carried across (analysis, metrics, flight
recorder, cost model, simulator), each on the same input as the JAX
module."""
import importlib
import types

import pytest
import torch
from conftest import check_result
from test_torch_executor import assert_raw_equal

from repro.core import ExecConfig as JaxConfig
from repro.core import QueryService as JaxService
from repro.core import compile_query as jax_compile
from repro.core.analysis import analyze_capflow as jax_capflow
from repro.core.analysis import verify_plan as jax_verify
from repro.core.obs import costmodel as jax_costmodel
from repro.core.obs import recorder as jax_recorder
from repro.core.queries import ALL
from repro_torch.core import (ExecConfig, Executor, InvalidArgumentError,
                              QueryService, compile_query, xdm)
from repro_torch.core.analysis import analyze_capflow, verify_plan
from repro_torch.core.obs import (FlightRecorder, MetricsRegistry,
                                  fit_cost_model)
from repro_torch.core.presize import presized_config
from repro_torch.core.rewrite import engine
from repro_torch.core.serving import events_from_trace, simulate
from repro_torch.core.workload import (DEFAULT_TENANTS, make_tenant_traffic,
                                       q12_variant)

jax_simulate = importlib.import_module("repro.core.serving.simulate")
STATIONS = ["GHCND:USW00012836", "GHCND:USW00014771",
            "GHCND:USW90000002", "GHCND:USW90000003"]
YEARS = (1976, 1999, 2000, 2001, 2003, 2004)
TINY = dict(scan_cap=1, join_bucket=1, join_cap=1, group_cap=2)
CAP_FIELDS = ("scan_cap", "join_cap", "group_cap", "topk_cap",
              "join_strategy", "join_bucket")
# presized_config with its defaults, on the weather_db fixture: the caps
# (scan, join, group, top-k) that chip_smoke.py's executor phase ran with
# before the serving tier took presizing over
EXECUTOR_CAPS = {
    "Q1": (192, None, None, None), "Q2": (192, None, None, None),
    "Q3": (192, None, None, None), "Q4": (192, None, None, None),
    "Q5": (192, 192, None, None), "Q6": (192, 192, None, None),
    "Q7": (192, 192, None, None), "Q8": (48, 48, None, None),
    "Q9": (192, None, 16, None), "Q10": (192, None, 16, None),
    "Q11": (192, None, 16, 16), "Q12": (192, None, 16, None),
}


@pytest.fixture(scope="module")
def db(weather_db):
    return xdm.database_from_arrays(*xdm.database_to_arrays(weather_db))


@pytest.fixture(scope="module")
def served(db):
    """The port's service and its result for every query."""
    svc = QueryService(db, device="cpu")
    return svc, {name: svc.execute(q) for name, q in ALL.items()}


@pytest.fixture(scope="module")
def jax_served(weather_db):
    svc = JaxService(weather_db)
    return svc, {name: svc.execute(q) for name, q in ALL.items()}


def caps(cfg) -> tuple:
    return tuple(getattr(cfg, f) for f in CAP_FIELDS)


@pytest.mark.parametrize("name", list(ALL))
def test_service_matches_reference(served, jax_served, oracle, name):
    """Q1–Q12 through the port's service: exact against the oracle, the
    JAX service's presized caps, and its raw dict."""
    svc, results = served
    jsvc, jresults = jax_served
    rs = results[name]
    assert not rs.overflow
    check_result(rs, oracle, name)
    pq = svc.prepare(ALL[name])
    assert caps(svc._presized_config(pq.plan)) == \
        caps(jsvc._presized_config(jsvc.prepare(ALL[name]).plan))
    assert_raw_equal(rs.raw, jresults[name].raw, name,
                     compile_query(ALL[name]))


def test_plan_cache_and_stats(served):
    svc, _ = served
    before = svc.stats.snapshot()
    svc.execute(ALL["Q9"])
    d = svc.stats.diff(before)
    assert (d.compiles, d.cache_hits, d.runs, d.retries) == (0, 1, 1, 0)
    assert svc.stats.compiles == svc.executor.compile_count == 12
    text = svc.metrics.exposition()
    assert "service_compiles_total 12" in text


@pytest.fixture(scope="module")
def tiny(db):
    return QueryService(db, ExecConfig(**TINY), presize=False, device="cpu")


@pytest.mark.parametrize("name", list(ALL))
def test_tiny_caps_regrow_to_exact(served, tiny, oracle, name):
    """From caps of 1 (2 groups), every query regrows to an exact
    result; the first run of each signature starts at the tiny caps."""
    before = tiny.stats.snapshot()
    rs = tiny.execute(served[0].prepare(ALL[name]))
    assert not rs.overflow
    check_result(rs, oracle, name)
    assert tiny.stats.diff(before).retries >= 1
    assert tiny.stats.compiles == tiny.executor.compile_count


@pytest.mark.parametrize("name", ["Q5", "Q10", "Q11"])
def test_regrowth_ladder_matches_reference(served, jax_served, db,
                                           weather_db, name):
    """The ladder takes the JAX service's configs, rung for rung."""
    svc = QueryService(db, ExecConfig(**TINY), presize=False, device="cpu")
    jsvc = JaxService(weather_db, JaxConfig(**TINY), presize=False)
    pq = served[0].prepare(ALL[name])
    jpq = jax_served[0].prepare(ALL[name])
    svc.execute(pq)
    jsvc.execute(jpq)
    sig = pq.signature
    assert sig == jpq.signature
    got, want = svc._sig_history[sig], jsvc._sig_history[sig]
    assert got["regrowths"] == want["regrowths"]
    assert got["compiles"] == want["compiles"]
    assert svc.stats.overflows_by_cap == jsvc.stats.overflows_by_cap
    assert caps(svc._good_cfg[sig]) == caps(jsvc._good_cfg[sig])


def test_overflow_error_when_retries_run_out(db):
    from repro_torch.core import QueryOverflowError
    svc = QueryService(db, ExecConfig(scan_cap=1), presize=False,
                       max_retries=0, device="cpu")
    with pytest.raises(QueryOverflowError):
        svc.execute(ALL["Q2"])


@pytest.mark.parametrize("name", ["Q2", "Q8", "Q11"])
def test_explain_profile_matches_reference(served, jax_served, name):
    svc, _ = served
    jsvc, _ = jax_served
    got = svc.explain(ALL[name], profile=True)
    want = jsvc.explain(ALL[name], profile=True)

    def ops(prof):
        return [(o.index, o.label, o.rows, o.rows_peak, o.fused, o.cap,
                 o.cap_value, o.static_bound, o.overflow) for o in prof.ops]

    assert ops(got) == ops(want)
    assert any(o.rows for o in got.ops)
    static = svc.explain(ALL[name])
    assert [o.rows for o in static.ops] == [None] * len(static.ops)


def test_submit_drain_equals_direct_execute(db):
    traffic = make_tenant_traffic(DEFAULT_TENANTS, STATIONS, YEARS,
                                  total=16, seed=1)
    svc = QueryService(db, device="cpu")
    for at, tenant, template, text in traffic:
        svc.submit(text, tenant=tenant, at=at, template=template)
    tickets = svc.drain()
    assert len(tickets) == len(traffic)
    assert svc.stats.batches >= 1
    for t, (_, _, _, text) in zip(tickets, traffic):
        assert t.error is None
        assert t.result.rows() == svc.execute(text).rows()


def test_windowed_stream_equals_one_shot(db):
    svc = QueryService(db, device="cpu")
    for i, y in enumerate(YEARS):
        svc.submit(q12_variant("PRCP", y), tenant="AB"[i % 2],
                   at=float(i), stream="prcp")
    assert all(t.error is None for t in svc.drain())
    one_shot = sorted(svc.execute('''
for $r in collection("/sensors")/dataCollection/data
where $r/dataType eq "PRCP"
group by $st := $r/station
return ($st, count($r), sum($r/value), min($r/value), max($r/value))
''').rows())
    assert svc.stream_result("prcp") == one_shot


def test_warmup_compiles_before_first_request(db):
    svc = QueryService(db, device="cpu")
    got = svc.warmup([ALL["Q2"], (ALL["Q9"], 4)])
    assert (got["templates"], got["variants"], got["compiles"]) == (2, 3, 3)
    svc.execute(ALL["Q2"])
    assert svc.stats.compiles == 3


def test_not_ported_options_raise(db, tmp_path):
    """The options that once raised as not ported: ``persist_dir``
    attaches the disk cache (tests/test_torch_persist.py); spmd mode
    runs over a mesh (tests/test_torch_spmd.py) and is refused without
    one, as is a mesh without spmd mode or an unknown mode; ``aot`` and
    ``donate`` compile (tests/test_torch_executor.py)."""
    svc = QueryService(db, persist_dir=str(tmp_path / "plans"),
                       device="cpu")
    assert svc.persist_info().entries == 0
    svc.execute(ALL["Q2"])
    assert svc.persist_info().entries == svc.stats.persist_stores == 1
    for kw in ({"mode": "spmd"}, {"mesh": object()}, {"mode": "x"}):
        with pytest.raises(InvalidArgumentError, match="mode"):
            QueryService(db, device="cpu", **kw)
    ex = Executor(db, device="cpu")
    plan = compile_query(ALL["Q2"])
    with pytest.raises(ValueError, match="mesh"):
        ex.compile(plan, mode="spmd")
    assert ex.compile(plan, aot=True).schema
    assert ex.compile(plan, donate=True).donated


def test_service_uploads_tables_at_build(db):
    """A sim-mode service puts its tables on the device when it is
    built, so its first request holds no upload; a bare Executor
    uploads at its first run."""
    svc = QueryService(db, device="cpu")
    assert svc.executor._tables is not None
    assert svc.stats.executions == svc.executor.compile_count == 0
    assert Executor(db, device="cpu")._tables is None


def test_service_defaults_to_cuda(db, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        QueryService(db)
    assert QueryService(db, device="cpu").executor.device.type == "cpu"


# -- presizing ---------------------------------------------------------------

@pytest.mark.parametrize("name", list(ALL))
def test_presize_defaults_keep_executor_caps(db, name):
    Executor(db, device="cpu")          # interns the derived strings
    got = presized_config(db, compile_query(ALL[name]))
    want = EXECUTOR_CAPS[name]
    assert got == ExecConfig(scan_cap=want[0], join_cap=want[1],
                             group_cap=want[2], topk_cap=want[3])


SETTINGS = {
    "repartition": (dict(join_strategy="repartition"), {}),
    "explicit_caps": (dict(scan_cap=64, group_cap=4), {}),
    "no_pushdown": ({}, dict(pushdown_topk=False)),
}


@pytest.fixture(scope="module")
def presizers(db, weather_db):
    """Per setting: the port's service and the JAX service."""
    return {k: (QueryService(db, ExecConfig(**base), device="cpu", **kw),
                JaxService(weather_db, JaxConfig(**base), **kw))
            for k, (base, kw) in SETTINGS.items()}


@pytest.mark.parametrize("setting", list(SETTINGS))
@pytest.mark.parametrize("name", list(ALL))
def test_presize_rules_match_reference(served, jax_served, presizers, name,
                                       setting):
    """Explicit caps win, the repartition join's cap is P times the
    scan cap, top-k is presized only under the pushdown — as in the JAX
    service."""
    svc, jsvc = presizers[setting]
    got = svc._presized_config(served[0].prepare(ALL[name]).plan)
    assert caps(got) == caps(jsvc._presized_config(
        jax_served[0].prepare(ALL[name]).plan))
    if setting == "repartition" and got.join_cap is not None:
        assert got.join_cap == min(4 * got.scan_cap,
                                   svc._joincap_ceiling)


def test_presize_off_runs_the_base_config(db):
    base = ExecConfig(scan_cap=32)
    svc = QueryService(db, base, presize=False, device="cpu")
    assert svc._presized_config(compile_query(ALL["Q8"])) is base


# -- host-only modules carried across -----------------------------------------

@pytest.mark.parametrize("name", list(ALL))
def test_analysis_matches_reference(db, weather_db, name):
    """verify_plan (schema inference, capacity flow, registry check)
    and analyze_capflow give the JAX module's results; the rewrite
    soundness mode passes every rule firing of the query."""
    prev = engine.set_soundness_checks(True)
    try:
        plan = compile_query(ALL[name])
    finally:
        engine.set_soundness_checks(prev)
    assert not engine.soundness_checks_enabled() or prev
    jplan = jax_compile(ALL[name])
    assert repr(verify_plan(plan, db=db)) == \
        repr(jax_verify(jplan, db=weather_db))
    assert repr(analyze_capflow(plan, db=db)) == \
        repr(jax_capflow(jplan, db=weather_db))


def test_metrics_export_matches_reference(served, jax_served):
    """A registry binding each service's stats, plus one counter, gauge
    and histogram fed alike, exports the same text and dict."""
    from repro.core.obs.metrics import MetricsRegistry as JaxRegistry
    outs = []
    for registry, svc in ((MetricsRegistry, served[0]),
                          (JaxRegistry, jax_served[0])):
        reg = registry()
        stats = type(svc.stats)(executions=12, runs=15, retries=3,
                                compiles=12, overflows_by_cap={"scan_cap": 3})
        reg.register_stats("service", stats)
        reg.counter("requests", help="demo").labels(tenant="a").inc(5)
        reg.gauge("depth", fn=lambda: 7)
        h = reg.histogram("latency_s")
        for v in (0.001, 0.02, 0.3, 4.0):
            h.observe(v)
        outs.append((reg.exposition(), reg.to_dict()))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("policy", ["pow2", "cost"])
def test_trace_costmodel_simulation_match_reference(db, policy):
    """One seeded multi-tenant run through the port's runtime, recorded:
    the trace loads in the JAX package byte for byte, both packages fit
    the same cost model from its service log, and both simulators
    replay the trace to the same latencies."""
    traffic = make_tenant_traffic(DEFAULT_TENANTS, STATIONS, YEARS,
                                  total=16, seed=3)
    svc = QueryService(db, device="cpu")
    rec = FlightRecorder()
    knobs = dict(window=2.0, max_fill=8, quantum=4)
    rt = svc.runtime(policy=policy, recorder=rec,
                     measure_service_time=True, **knobs)
    for at, tenant, template, text in traffic:
        rt.submit(text, tenant=tenant, at=at, template=template)
    assert all(t.error is None for t in rt.drain())
    trace = rec.trace()
    jtrace = jax_recorder.load_trace(trace.dumps())
    assert jtrace.dumps() == trace.dumps()
    log = types.SimpleNamespace(service_log=list(rt.service_log))
    cm = fit_cost_model(log)
    assert cm.to_json() == jax_costmodel.fit_cost_model(log).to_json()
    got = simulate(events_from_trace(trace), policy=policy, cost_model=cm,
                   **knobs)
    want = jax_simulate.simulate(
        jax_simulate.events_from_trace(jtrace), policy=policy,
        cost_model=jax_costmodel.CostModel.from_json(cm.to_json()), **knobs)
    assert got.summary() == want.summary()
    assert got.latencies() == want.latencies()


def test_chip_smoke_service_path_rehearsal_on_cpu():
    """chip_smoke.py's phase 6 at a tiny scale on the CPU (the plain
    versions stand in for the kernels): both routes, the numpy
    reference, the workload's compiles and batches, regrowth from caps
    of 1, the admission runtime and the restart on a persistent plan
    cache."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.data.weather import WeatherSpec, build_database
    spec = WeatherSpec(num_stations=12, years=(1976, 1999, 2000, 2001, 2003),
                       days_per_year=3)
    out = chip_smoke.service_path(build_database(spec, 4), spec,
                                  torch.device("cpu"), total=12)
    assert [r["query"] for r in out["queries"]] == list(ALL)
    assert all(r["compiles"] == 1 and r["retries"] == 0
               for r in out["queries"])
    assert (out["workload"]["compiles"], out["workload"]["batches"]) == (3, 3)
    assert all(r["retries"] > 0 for r in out["regrowth"].values())
    assert (out["restart"]["stores"], out["restart"]["compiles"],
            out["restart"]["persist_hits"]) == (len(ALL), 0, len(ALL))
