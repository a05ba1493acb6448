"""Spmd mode of the PyTorch port over ``torch.distributed`` (gloo, CPU).

Four ranks are spawned in subprocesses on the ``weather_db`` fixture's
data with P = 4, one partition a rank. Each rank runs Q1–Q12 on both
join strategies through ``Executor.run(mode="spmd")``; every rank's
raw-output dict must equal the port's sim-mode dict on the same
database bit for bit (the spmd collectives gather, then reduce as sim
mode does), and its rows must match the SaxonLike oracle. Q5, Q8
(repartition) and Q9 (group_cap=16) are also held against the JAX
package's ``mode="spmd"`` on 4 forced host devices, run in a JAX
subprocess as tests/test_distributed.py does (float sums and divisions
to rtol=1e-5, the rest exact). The ranks also run a batched service
against per-request runs, the service's regrowth ladder from caps of
1, and a donated plan.

Every spawned group gets a free port and its own timeout, so a hung
rendezvous fails its test instead of eating the suite's time.
"""
import os
import pickle
import socket
import subprocess
import sys
from contextlib import closing

import numpy as np
import pytest
import torch
import torch.distributed as dist
from conftest import check_result
from test_torch_executor import assert_raw_equal

from repro.core.queries import ALL, JOINS
from repro_torch.core import (ExecConfig, Executor, QueryService,
                              compile_query, xdm)
from repro_torch.core.executor import ResultSet
from repro_torch.core.workload import variant_grid
from repro_torch.launch.mesh import make_data_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
GROUP_TIMEOUT_S = 120
STRATEGIES = ("broadcast", "repartition")
# held against the JAX package's spmd mode: (query, config)
AGAINST_JAX = {"Q5": {}, "Q8": {"join_strategy": "repartition"},
               "Q9": {"group_cap": 16}}
STATIONS = ["GHCND:USW00012836", "GHCND:USW00014771"]
YEARS = (1976, 2000, 2001)
TINY = dict(scan_cap=1, join_bucket=1, join_cap=1, group_cap=2)
REGROWN = ("Q8", "Q10", "Q11")
# through a persistent plan cache whose state differs between ranks
PERSISTED = ("Q2", "Q5", "Q8", "Q11")


def free_port() -> int:
    with closing(socket.socket(socket.AF_INET, socket.SOCK_STREAM)) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def batch_texts() -> list[str]:
    return variant_grid("Q1", STATIONS, YEARS, 4) \
        + variant_grid("Q3", STATIONS, YEARS, 3)


RANK_SCRIPT = r'''
import os, pickle, shutil, sys
from datetime import timedelta
import torch.distributed as dist
from repro_torch.core import ExecConfig, Executor, QueryService, compile_query, xdm
from repro_torch.core.queries import ALL
from repro_torch.launch.mesh import make_data_mesh

rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
out = os.environ["SPMD_OUT"]
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + os.environ["SPMD_PORT"],
                        rank=rank, world_size=world, timeout=timedelta(seconds=90))
mesh = make_data_mesh("cpu")
with open(os.path.join(out, "job.pkl"), "rb") as f:
    job = pickle.load(f)
db = xdm.database_from_arrays(*job["db"])
res = {"queries": {}, "capped": {}, "regrowth": {}}
for strategy in ("broadcast", "repartition"):
    ex = Executor(db, ExecConfig(join_strategy=strategy), device="cpu")
    for name, text in ALL.items():
        cp = ex.compile(compile_query(text), mode="spmd", mesh=mesh)
        res["queries"][strategy, name] = (ex.run_compiled(cp).raw, dict(cp.schema))
    res["sim_tables_uploaded"] = ex._tables is not None
    res["rank_rows"] = {k: tuple(v["kind"].shape)
                        for k, v in ex.partition_tables(rank).items() if k != "__derived__"}
    res["gathered_bytes"] = ex.gathered_bytes
ex = Executor(db, device="cpu")
for name, cfg in job["against_jax"].items():
    res["capped"][name] = ex.run(compile_query(ALL[name]), mode="spmd", mesh=mesh,
                                 config=ExecConfig(**cfg)).raw
texts = job["texts"]
svc = QueryService(db, mode="spmd", mesh=mesh, device="cpu")
res["per_request"] = [svc.execute(t).raw for t in texts]
svc = QueryService(db, mode="spmd", mesh=mesh, device="cpu")
res["batched"] = [rs.raw for rs in svc.execute_batch(texts)]
res["batches"] = svc.stats.batches
svc = QueryService(db, mode="spmd", mesh=mesh, device="cpu")
for i, t in enumerate(texts):
    svc.submit(t, at=0.001 * i)
res["drained"] = [t.result.raw for t in svc.drain()]
svc = QueryService(db, ExecConfig(**job["tiny"]), presize=False, max_retries=24,
                   mode="spmd", mesh=mesh, device="cpu")
for name in job["regrown"]:
    before = svc.stats.retries
    rs = svc.execute(ALL[name])
    res["regrowth"][name] = (rs.raw, dict(rs.schema), svc.stats.retries - before)
ex = Executor(db, device="cpu")
plan = compile_query(ALL["Q4"])
res["donated"] = ex.run_compiled(ex.compile(plan, mode="spmd", mesh=mesh, donate=True)).raw
try:
    ex.run(plan, mode="spmd", mesh=mesh)
    res["after_donate"] = "ran"
except RuntimeError as e:
    res["after_donate"] = str(e)
pdir = os.path.join(out, f"plans{rank}")
svc = QueryService(db, mode="spmd", mesh=mesh, device="cpu", persist_dir=pdir)
res["persist_first"] = {name: svc.execute(ALL[name]).raw for name in job["persisted"]}
if rank == 1:                   # this rank restarts with an empty cache
    shutil.rmtree(pdir)
elif rank == 2:                 # and this one with corrupt entries
    for fname in os.listdir(pdir):
        with open(os.path.join(pdir, fname), "r+b") as fh:
            blob = bytearray(fh.read())
            blob[len(blob) // 2] ^= 0xFF
            fh.seek(0)
            fh.write(bytes(blob))
svc = QueryService(db, mode="spmd", mesh=mesh, device="cpu", persist_dir=pdir)
svc.warmup([ALL[job["persisted"][0]]])
res["persist_restart"] = {}
for name in job["persisted"]:
    rs = svc.execute(ALL[name])
    res["persist_restart"][name] = (rs.raw, dict(rs.schema))
res["persist_stats"] = (svc.stats.compiles, svc.stats.persist_hits,
                        svc.stats.persist_invalidations)
with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(res, f)
dist.barrier()
dist.destroy_process_group()
'''

JAX_SCRIPT = r'''
import pickle, sys
from repro import compat
from repro.core import ExecConfig, Executor, compile_query
from repro.core.queries import ALL
from repro.data.weather import WeatherSpec, build_database
with open(sys.argv[2], "rb") as f:
    job = pickle.load(f)
db = build_database(WeatherSpec(num_stations=8, years=(1976, 1999, 2000, 2001, 2003, 2004),
                                days_per_year=3), num_partitions=4)
mesh = compat.make_mesh((4,), ("data",))
out = {name: Executor(db, ExecConfig(**cfg)).run(compile_query(ALL[name]), mode="spmd",
                                                  mesh=mesh).raw
       for name, cfg in job["against_jax"].items()}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
'''


def _env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env.update(extra)
    return env


def _start(args: list, log, **env) -> subprocess.Popen:
    """One process of a group, its output to the file ``log``."""
    fh = open(log, "w")
    proc = subprocess.Popen([sys.executable, "-c"] + args, stdout=fh,
                            stderr=subprocess.STDOUT, env=_env(**env))
    proc.log_file = fh
    return proc


def _wait(procs, logs, what: str) -> None:
    """Wait for every process of one group within GROUP_TIMEOUT_S;
    kill them all and fail on a hang or an error."""
    try:
        for p in procs:
            p.wait(timeout=GROUP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"{what} did not finish in {GROUP_TIMEOUT_S} s")
    finally:
        for p in procs:
            p.log_file.close()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"{what}: {open(log).read()[-4000:]}"


@pytest.fixture(scope="module")
def db(weather_db):
    return xdm.database_from_arrays(*xdm.database_to_arrays(weather_db))


@pytest.fixture(scope="module")
def ranks(weather_db, tmp_path_factory):
    """Per-rank results of the 4-rank gloo group and the JAX package's
    spmd raw dicts, run side by side."""
    out = tmp_path_factory.mktemp("spmd")
    job = out / "job.pkl"
    with open(job, "wb") as f:
        pickle.dump({"db": xdm.database_to_arrays(weather_db),
                     "against_jax": AGAINST_JAX, "texts": batch_texts(),
                     "tiny": TINY, "regrown": REGROWN,
                     "persisted": PERSISTED}, f)
    port = str(free_port())
    logs = [out / f"rank{r}.log" for r in range(WORLD)]
    group = [_start([RANK_SCRIPT], logs[r], RANK=str(r),
                    WORLD_SIZE=str(WORLD), SPMD_PORT=port, SPMD_OUT=str(out))
             for r in range(WORLD)]
    jax_out = out / "jax.pkl"
    jax_log = out / "jax.log"
    jax_proc = _start([JAX_SCRIPT, str(jax_out), str(job)], jax_log,
                      JAX_PLATFORMS="cpu", XLA_FLAGS=(
                          "--xla_force_host_platform_device_count=4"))
    _wait(group, logs, "the 4-rank gloo group")
    _wait([jax_proc], [jax_log], "the JAX spmd run")
    got = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    with open(jax_out, "rb") as f:
        return got, pickle.load(f)


@pytest.fixture(scope="module")
def sim(db):
    """The port's sim-mode raw dicts on the same database."""
    runs = {}
    for strategy in STRATEGIES:
        ex = Executor(db, ExecConfig(join_strategy=strategy), device="cpu")
        for name, text in ALL.items():
            runs[strategy, name] = ex.run(compile_query(text)).raw
    return runs


def assert_identical(a: dict, b: dict, what: str) -> None:
    """Two raw dicts bit for bit: same keys, shapes, dtypes, values."""
    assert set(a) == set(b), what
    for k in a:
        xs = a[k] if isinstance(a[k], tuple) else (a[k],)
        ys = b[k] if isinstance(b[k], tuple) else (b[k],)
        assert len(xs) == len(ys), (what, k)
        for x, y in zip(xs, ys):
            assert x.shape == y.shape and x.dtype == y.dtype, (what, k)
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {k}")


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("name", list(ALL))
def test_spmd_ranks_equal_sim(ranks, sim, db, oracle, strategy, name):
    got, _ = ranks
    for r, res in enumerate(got):
        raw, schema = res["queries"][strategy, name]
        assert_identical(raw, sim[strategy, name], f"rank {r} {name}")
    raw, schema = got[0]["queries"][strategy, name]
    rs = ResultSet(db, compile_query(ALL[name]), raw, schema)
    assert not rs.overflow
    check_result(rs, oracle, name)


@pytest.mark.parametrize("name", list(AGAINST_JAX))
def test_spmd_matches_jax_spmd(ranks, name):
    got, jax_raw = ranks
    plan = compile_query(ALL[name])
    for res in got:
        assert_raw_equal(res["capped"][name], jax_raw[name], name, plan)


def test_spmd_rank_holds_its_partition_only(ranks, db):
    """Each rank uploads its own partition ([1, N] a column) and never
    sim mode's P-partition tables; the exchanges moved bytes."""
    got, _ = ranks
    width = Executor(db, device="cpu").padded_rows()
    for res in got:
        assert not res["sim_tables_uploaded"]
        assert all(s[0] == 1 and s[1] <= width
                   for s in res["rank_rows"].values())
        assert res["gathered_bytes"] > 0


def test_spmd_batched_equals_per_request(ranks):
    got, _ = ranks
    texts = batch_texts()
    for res in got:
        assert res["batches"] == 2
        for a, b, c in zip(res["per_request"], res["batched"],
                           res["drained"]):
            assert_identical(a, b, "batched")
            assert_identical(a, c, "drained")
    assert len(got[0]["batched"]) == len(texts)
    for res in got[1:]:
        for a, b in zip(res["batched"], got[0]["batched"]):
            assert_identical(a, b, "rank")


@pytest.mark.parametrize("name", REGROWN)
def test_spmd_service_regrowth_ladder(ranks, db, oracle, name):
    """The regrowth ladder from caps of 1 stays in lockstep: every rank
    reads the same gathered flags and retries the same number of
    times, to the oracle's rows."""
    got, _ = ranks
    raw, schema, retries = got[0]["regrowth"][name]
    assert retries > 0
    for res in got[1:]:
        assert res["regrowth"][name][2] == retries
        assert_identical(res["regrowth"][name][0], raw, name)
    rs = ResultSet(db, compile_query(ALL[name]), raw, schema)
    assert not rs.overflow
    check_result(rs, oracle, name)


@pytest.mark.parametrize("name", PERSISTED)
def test_spmd_persist_restart_with_differing_caches(ranks, db, oracle,
                                                    name):
    """A restarted spmd service where rank 1's disk cache is empty and
    rank 2's entries are corrupt, while ranks 0 and 3 load theirs: a
    load and a compile are followed by the same runs, so the ranks'
    collectives stay paired and every rank returns the first service's
    bits."""
    got, _ = ranks
    want = got[0]["persist_first"][name]
    n = len(PERSISTED)
    for r, res in enumerate(got):
        assert_identical(res["persist_first"][name], want, f"rank {r}")
        raw, schema = res["persist_restart"][name]
        assert_identical(raw, want, f"rank {r} restarted")
        compiles, hits, invalid = res["persist_stats"]
        if r == 1:
            assert (compiles, hits, invalid) == (n, 0, 0)
        elif r == 2:
            assert (compiles, hits, invalid) == (n, 0, n)
        else:
            assert (compiles, hits, invalid) == (0, n, 0)
    rs = ResultSet(db, compile_query(ALL[name]), raw, schema)
    assert not rs.overflow
    check_result(rs, oracle, name)


def test_spmd_donated_run_releases_tables(ranks, sim):
    got, _ = ranks
    for res in got:
        assert_identical(res["donated"], sim["broadcast", "Q4"], "donated")
        assert "donated" in res["after_donate"]


@pytest.fixture
def one_rank_group():
    """An in-process gloo group of one rank, destroyed afterwards."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        yield make_data_mesh("cpu")
    finally:
        dist.destroy_process_group()


def test_partitions_differ_from_group_raises(db, one_rank_group):
    """P = 4 on a group of one rank: no part of the data is run
    quietly."""
    mesh = one_rank_group
    plan = compile_query(ALL["Q1"])
    with pytest.raises(ValueError, match="4 partitions, the group 1"):
        Executor(db, device="cpu").compile(plan, mode="spmd", mesh=mesh)
    with pytest.raises(ValueError, match="one partition a rank"):
        QueryService(db, mode="spmd", mesh=mesh, device="cpu")


@pytest.mark.parametrize("name", JOINS)
def test_one_rank_spmd_equals_sim(one_rank_group, name):
    """P = 1 on one rank: the shape the card runs (a one-rank NCCL
    group), here over gloo."""
    from repro_torch.data.weather import WeatherSpec, build_database
    db1 = build_database(WeatherSpec(num_stations=6, years=(1976, 2000),
                                     days_per_year=2), 1)
    ex = Executor(db1, device="cpu")
    plan = compile_query(ALL[name])
    got = ex.run(plan, mode="spmd", mesh=one_rank_group)
    assert_identical(got.raw, ex.run(plan).raw, name)


def test_one_rank_service_uploads_its_partition_at_build(one_rank_group):
    """An spmd service puts its rank's partition on the device when it
    is built, and never sim mode's tables."""
    from repro_torch.data.weather import WeatherSpec, build_database
    db1 = build_database(WeatherSpec(num_stations=6, years=(1976, 2000),
                                     days_per_year=2), 1)
    svc = QueryService(db1, mode="spmd", mesh=one_rank_group, device="cpu")
    assert list(svc.executor._rank_tables) == [0]
    assert svc.executor._tables is None


def test_make_data_mesh_needs_a_group(monkeypatch):
    """No group is started silently; the device defaults to CUDA."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_data_mesh("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_data_mesh()


def test_xquery_cluster_cli_under_torchrun(tmp_path):
    """``launch.xquery_cluster`` started by torchrun on two gloo ranks:
    rank 0 prints every query on both strategies and the service's
    cold/warm runs, with one compile a query."""
    log = tmp_path / "cluster.log"
    # --standalone: torchrun binds its own rendezvous port (no port is
    # picked here and bound later, which another process could take)
    proc = _start(["from torch.distributed.run import main; main()",
                   "--standalone", "--nproc-per-node", "2", "-m",
                   "repro_torch.launch.xquery_cluster", "--device", "cpu",
                   "--stations", "8", "--first-year", "2000", "--days", "3",
                   "--queries", "Q5", "Q8"], log)
    _wait([proc], [log], "torchrun")
    out = open(log).read()
    assert "2 ranks on cpu" in out
    for name in ("Q5", "Q8"):
        for route in ("broadcast", "repartition", "service"):
            assert f"{name} [{route:11s}] -> " in out, (name, route, out)
    assert "25.433" in out                      # Q8's scalar
    assert "service stats: compiles 2, retries 0" in out
