"""Prepared, batched and profile compiles of the PyTorch port
(device="cpu"), on a database carried across from the ``weather_db``
fixture: parameter lifting against the JAX package's, bound parameters
as 0-d device tensors, constant-variants sharing one compile, a
prepared run bit-equal to the baked plan's, and ``execute_batch``
equal to per-request ``execute`` (grouped outputs and a batch that
overflows and regrows included)."""
import numpy as np
import pytest
import torch
from conftest import canon
from test_torch_executor import assert_raw_equal

from repro.core import lift_params as jax_lift
from repro.core import compile_query as jax_compile
from repro.core.queries import ALL, SCALAR
from repro_torch.core import (ExecConfig, Executor, QueryService,
                              compile_query, lift_params, xdm)
from repro_torch.core.executor import example_params, to_numpy
from repro_torch.core.prepared import (ParamSpec, bind_params,
                                       stack_params)
from repro_torch.core.workload import (gq6_variant, make_workload,
                                       q1_variant, q2_variant, q3_variant,
                                       q9d_variant, q10_variant)

STATIONS = ["GHCND:USW00012836", "GHCND:USW00014771", "GHCND:USW90000003"]
YEARS = (1976, 1999, 2000, 2003)


@pytest.fixture(scope="module")
def db(weather_db):
    return xdm.database_from_arrays(*xdm.database_to_arrays(weather_db))


@pytest.fixture(scope="module")
def ex(db):
    return Executor(db, device="cpu")


def service(db, *args, **kw):
    return QueryService(db, *args, device="cpu", **kw)


@pytest.mark.parametrize("name", list(ALL))
def test_lift_matches_reference(name):
    """The port lifts the same literals into the same slots as the JAX
    package, and the erased plans print alike (the signature)."""
    erased, specs, defaults = lift_params(compile_query(ALL[name]))
    jerased, jspecs, jdefaults = jax_lift(jax_compile(ALL[name]))
    assert [s.typ for s in specs] == [s.typ for s in jspecs]
    assert defaults == jdefaults and specs
    assert repr(erased) == repr(jerased)


@pytest.mark.parametrize("name", list(ALL))
def test_prepared_run_equals_baked_plan(db, ex, name):
    """A prepared run (literals as parameter tensors) gives the baked
    plan's raw dict bit for bit, divisions included."""
    svc = service(db)
    rs = svc.execute(ALL[name])
    plan = compile_query(ALL[name])
    baked = ex.run(plan, config=svc.cached_configs()[0])
    assert not rs.overflow
    assert set(rs.raw) == set(baked.raw)
    for k, v in baked.raw.items():
        parts = zip(rs.raw[k], v) if isinstance(v, tuple) \
            else [(rs.raw[k], v)]
        for g, w in parts:
            np.testing.assert_array_equal(g, w, err_msg=f"{name} {k}")
    if name in SCALAR:
        assert rs.scalar() == baked.scalar()


def test_bound_parameters_are_device_scalars(db):
    """Strings bind to int32 sids, numbers to float32, dates to packed
    int32 — 0-d tensors on the executor's device; a stack is
    [B]-leading, padded with the last binding."""
    specs = (ParamSpec("str"), ParamSpec("num"), ParamSpec("date"))
    got = bind_params(db, specs, ("TMAX", 2.5, "2000-07-04T00:00:00.000"),
                      device="cpu")
    assert [t.dtype for t in got] == [torch.int32, torch.float32,
                                      torch.int32]
    assert all(t.dim() == 0 and t.device.type == "cpu" for t in got)
    assert int(got[0]) == db.strings.lookup("TMAX")
    assert float(got[1]) == 2.5 and int(got[2]) == 20000704
    other = bind_params(db, specs, ("NO-SUCH", -1.0, 19991231))
    assert int(other[0]) < 0
    stacked = stack_params([got, other], 4)
    assert [tuple(t.shape) for t in stacked] == [(4,)] * 3
    assert stacked[1].tolist() == [2.5, -1.0, -1.0, -1.0]
    assert [t.dtype for t in example_params(specs, batch=3)] == \
        [torch.int32, torch.float32, torch.int32]
    with pytest.raises(ValueError, match="parameters"):
        bind_params(db, specs, ("TMAX",))


def test_config_keys_follow_the_dataclass_fields():
    cfg = ExecConfig(scan_cap=64, group_cap=16)
    assert cfg.signature() == tuple(getattr(cfg, f) for f in (
        "scan_cap", "join_cap", "group_cap", "topk_cap", "join_strategy",
        "join_bucket", "use_kernel_join", "use_kernel_segments"))
    assert cfg.cap_key() == cfg.signature()
    assert ExecConfig(scan_cap=64).cap_key() != cfg.cap_key()


def test_constant_variants_share_one_compile(db, ex):
    svc = service(db)
    a = q1_variant("GHCND:USW00012836", 2003, 12, 25)
    b = q1_variant("GHCND:USW00014771", 1999, 7, 4)
    pa, pb = svc.prepare(a), svc.prepare(b)
    assert pa.signature == pb.signature and pa.defaults != pb.defaults
    ra = svc.execute(a)
    compiles = svc.stats.compiles
    rb = svc.execute(b)
    assert svc.stats.compiles == compiles == svc.executor.compile_count
    assert svc.stats.cache_hits >= 1
    assert ra.rows() == ex.run(compile_query(a)).rows()
    assert rb.rows() == ex.run(compile_query(b)).rows()
    assert ra.rows() != rb.rows()


def test_groupby_variants_share_one_compile(db, ex):
    svc = service(db)
    for a, b in ((q10_variant("TMAX", 50.0), q10_variant("PRCP", 125.0)),
                 (q9d_variant("TMAX", 10), q9d_variant("TMIN", 13)),
                 (gq6_variant("TMAX", 2000), gq6_variant("PRCP", 1999))):
        assert svc.prepare(a).signature == svc.prepare(b).signature
        svc.execute(a)
        compiles = svc.stats.compiles
        rb = svc.execute(b)
        assert svc.stats.compiles == compiles
        assert rb.rows() == ex.run(compile_query(b)).rows()


def test_explicit_bindings_override_defaults(db):
    svc = service(db)
    pq = svc.prepare(q3_variant("GHCND:USW00014771", "PRCP", 1999))
    assert sorted(s.typ for s in pq.specs) == ["num", "num", "str", "str"]
    swap = {"GHCND:USW00014771": "GHCND:USW00012836", "PRCP": "TMAX",
            1999.0: 2000.0}
    other = tuple(swap.get(v, v) for v in pq.defaults)
    rs = svc.execute(pq, bindings=other)
    inline = svc.execute(q3_variant("GHCND:USW00012836", "TMAX", 2000))
    assert rs.scalar() == inline.scalar()


def test_unknown_string_binding_yields_empty(db):
    svc = service(db)
    pq = svc.prepare(q2_variant("AWND", 100.0))
    assert svc.execute(pq, bindings=("NO-SUCH-TYPE", 100.0)).rows() == []


def test_binding_arity_checked(db):
    svc = service(db)
    pq = svc.prepare(q2_variant("AWND", 100.0))
    with pytest.raises(ValueError, match="parameters"):
        svc.execute(pq, bindings=("AWND",))
    cp = svc.executor.compile(pq.plan, param_specs=pq.specs)
    with pytest.raises(ValueError, match="expects 2 parameters"):
        svc.executor.run_compiled(cp)
    with pytest.raises(ValueError, match="needs parameters"):
        svc.executor.compile(pq.plan, batch=2)


def test_prepare_idempotent_on_erased_plan(db):
    svc = service(db)
    pq = svc.prepare(q2_variant("AWND", 100.0))
    pq2 = svc.prepare(pq.plan)
    assert pq2.signature == pq.signature and pq2.defaults is None
    assert svc.execute(pq.plan, bindings=pq.defaults).rows() == \
        svc.execute(pq).rows()
    with pytest.raises(ValueError, match="binding"):
        svc.execute(pq.plan)


def test_batch_matches_per_request_results(db):
    wl = [q for _, q in make_workload(STATIONS, YEARS, total=12)]
    single, batch = service(db), service(db)
    singles = [single.execute(q) for q in wl]
    batched = batch.execute_batch(wl)
    assert [s.rows() for s in singles] == [b.rows() for b in batched]
    for s, b in zip(singles, batched):
        assert set(s.raw) == set(b.raw)
        np.testing.assert_array_equal(s.raw["valid"], b.raw["valid"])
    assert (batch.stats.batches, batch.stats.batched_requests,
            batch.stats.compiles) == (3, 12, 3)


def test_batched_call_stacks_outputs(db):
    """One batched call: every output [B, P, ...], the padding slices a
    repeat of the last binding."""
    svc = service(db)
    pq = svc.prepare(q2_variant("AWND", 100.0))
    bound = [bind_params(db, pq.specs, v) for v in
             (("AWND", 100.0), ("PRCP", 50.0), ("TMAX", 0.0))]
    cp = svc.executor.compile(pq.plan, param_specs=pq.specs, batch=4)
    raw = to_numpy(cp.fn(svc.executor.tables, stack_params(bound, 4)))
    p = svc.executor.num_partitions
    assert raw["valid"].shape[:2] == (4, p)
    np.testing.assert_array_equal(raw["valid"][3], raw["valid"][2])
    rss = svc.executor.run_compiled_batch(cp, stack_params(bound, 4), 3)
    for rs, b in zip(rss, bound):
        one = svc.executor.run_compiled(
            svc.executor.compile(pq.plan, param_specs=pq.specs), b)
        assert rs.rows() == one.rows()


def test_batch_grouped_outputs(db):
    reqs = [q10_variant("TMAX", 50.0), q10_variant("PRCP", 1e9),
            q10_variant("TMIN", -1e9), q10_variant("TMAX", 125.0)]
    single, batch = service(db), service(db)
    singles = [single.execute(q) for q in reqs]
    batched = batch.execute_batch(reqs)
    assert [s.rows() for s in singles] == [b.rows() for b in batched]
    assert batched[1].rows() == [] and batched[0].rows()
    assert (batch.stats.batches, batch.stats.compiles) == (1, 1)


def test_batch_overflow_regrows_to_exact(db):
    svc = service(db, ExecConfig(scan_cap=4), presize=False)
    reqs = [q2_variant("AWND", 50.0 * i) for i in range(4)]
    out = svc.execute_batch(reqs)
    oracle = service(db)
    for q, rs in zip(reqs, out):
        assert not rs.overflow
        assert canon(rs.rows()) == canon(oracle.execute(q).rows())
    assert svc.stats.retries >= 1 and svc.stats.batches == 1


def test_profile_compile_counts_rows_per_partition(db, ex):
    """profile=True adds ``prof_rows`` [P, ops] and the op order; the
    serving outputs stay those of a normal compile."""
    plan = compile_query(ALL["Q2"])
    normal = ex.run_compiled(ex.compile(plan))
    prof = ex.run_compiled(ex.compile(plan, profile=True))
    assert normal.op_rows() is None
    assert prof.raw["prof_rows"].shape[0] == ex.num_partitions
    rows = prof.op_rows()
    assert rows[0] == len(normal.rows())            # DISTRIBUTE-RESULT
    assert prof.op_rows_peak()[0] <= rows[0]
    assert_raw_equal({k: v for k, v in prof.raw.items()
                      if k != "prof_rows"}, normal.raw, "Q2", plan)
    assert sorted(rows) == sorted(prof.profile_meta["order"])
