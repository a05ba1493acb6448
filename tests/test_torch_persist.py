"""The port's persistent plan cache (core/persist.py) and the service's
``persist_dir``: analogues of tests/test_persist.py.

An entry holds the plan as compiled, its resolved config, parameter
specs, batch width and column schema; a restarted service rebuilds the
closure from it (a load, not a compile) and gives the same bits. The
fingerprint holds the torch/CUDA versions, the device, the group size,
the partitions, a digest of the kernel sources and of the database."""
import os
import shutil

import pytest
from conftest import check_result
from test_torch_spmd import assert_identical

from repro.core.queries import ALL
from repro_torch.core import InvalidArgumentError, QueryService, xdm
from repro_torch.core import persist

TEMPLATES = ("Q2", "Q11")      # scan filter + ordered group-by top-k
BATCHED = "Q2"
BUCKET = 4


@pytest.fixture(scope="module")
def db(weather_db):
    return xdm.database_from_arrays(*xdm.database_to_arrays(weather_db))


def service(db, d, **kw):
    return QueryService(db, persist_dir=d, device="cpu", **kw)


def check(rs, oracle, name):
    assert not rs.overflow
    check_result(rs, oracle, name)


@pytest.fixture(scope="module")
def warm_cache(db, tmp_path_factory):
    """A cache directory seeded once: the scalar variants of every
    template and one batched variant, with the seeding run's raw
    dicts."""
    d = str(tmp_path_factory.mktemp("plancache"))
    svc = service(db, d)
    raws = {n: svc.execute(ALL[n]).raw for n in TEMPLATES}
    pq = svc.prepare(ALL[BATCHED])
    rss = svc.serve_group(pq, [pq.defaults] * 3, bucket=BUCKET)
    raws["batched"] = [rs.raw for rs in rss]
    assert svc.stats.persist_stores == svc.stats.compiles == 3
    assert svc.persist_info().entries == 3
    return d, raws


def test_restart_zero_recompiles_bitwise_parity(db, oracle, warm_cache):
    d, raws = warm_cache
    svc = service(db, d)
    for name in TEMPLATES:
        rs = svc.execute(ALL[name])
        assert_identical(rs.raw, raws[name], name)
        check(rs, oracle, name)
    pq = svc.prepare(ALL[BATCHED])
    rss = svc.serve_group(pq, [pq.defaults] * 3, bucket=BUCKET)
    for rs, want in zip(rss, raws["batched"]):
        assert_identical(rs.raw, want, "batched")
    # the restarted service compiled nothing: each variant was a load
    assert svc.stats.compiles == 0
    assert svc.executor.compile_count == 0
    assert svc.stats.persist_hits == 3
    assert svc.stats.persist_invalidations == 0
    snap = svc.stats.snapshot()
    for name in TEMPLATES:
        svc.execute(ALL[name])
    d2 = svc.stats.diff(snap)
    assert d2.compiles == 0 and d2.persist_hits == 0
    assert d2.cache_hits == len(TEMPLATES)


def test_restart_serves_every_query(db, oracle, tmp_path):
    """Q1–Q12 after a restart: 12 loads, no compile, the same bits."""
    d = str(tmp_path / "all")
    first = service(db, d)
    raws = {n: first.execute(q).raw for n, q in ALL.items()}
    svc = service(db, d)
    for name, q in ALL.items():
        rs = svc.execute(q)
        assert_identical(rs.raw, raws[name], name)
        check(rs, oracle, name)
    assert (svc.stats.compiles, svc.executor.compile_count,
            svc.stats.persist_hits) == (0, 0, len(ALL))


def test_compile_runs_the_query_once(db, tmp_path):
    """With persistence on, a request that compiles runs its plan once:
    the entry is stored after that run, with the schema it filled."""
    svc = service(db, str(tmp_path / "once"))
    calls = []
    real = svc.executor._call
    svc.executor._call = lambda cp, params=(): calls.append(cp) or \
        real(cp, params)
    svc.execute(ALL["Q11"])
    assert len(calls) == 1
    assert svc.stats.compiles == svc.stats.persist_stores == 1


def test_warmup_from_warm_disk_zero_compiles(db, warm_cache):
    d, raws = warm_cache
    svc = service(db, d)
    summary = svc.warmup([ALL[n] for n in TEMPLATES]
                         + [(ALL[BATCHED], BUCKET)])
    assert summary["compiles"] == 0
    assert summary["persist_hits"] == 3
    assert summary["variants"] == 3
    for name in TEMPLATES:
        assert_identical(svc.execute(ALL[name]).raw, raws[name], name)
    assert svc.stats.compiles == 0


def test_warmup_cold_compiles_and_stores(db, tmp_path):
    d = str(tmp_path / "cold")
    svc = service(db, d)
    summary = svc.warmup([ALL["Q4"]])
    assert summary["compiles"] == 1 and summary["persist_hits"] == 0
    assert svc.stats.persist_stores == 1
    again = svc.warmup([ALL["Q4"]])
    assert again["compiles"] == 0 and again["cache_hits"] == 1
    svc2 = service(db, d)
    assert svc2.warmup([ALL["Q4"]])["compiles"] == 0
    assert svc2.stats.persist_hits == 1


def test_corrupt_entries_degrade_to_recompile(db, oracle, warm_cache,
                                              tmp_path):
    d0, raws = warm_cache
    d = str(tmp_path / "corrupt")
    shutil.copytree(d0, d)
    files = sorted(f for f in os.listdir(d) if f.endswith(".plan"))
    assert files
    # truncation, a flipped body byte, a clobbered header
    for i, name in enumerate(files):
        p = os.path.join(d, name)
        blob = bytearray(open(p, "rb").read())
        if i % 3 == 0:
            blob = blob[:len(blob) // 2]
        elif i % 3 == 1:
            blob[len(blob) // 2] ^= 0xFF
        else:
            blob[:8] = b"XXXXXXXX"
        with open(p, "wb") as fh:
            fh.write(bytes(blob))
    svc = service(db, d)
    name = TEMPLATES[0]
    rs = svc.execute(ALL[name])
    assert_identical(rs.raw, raws[name], name)
    check(rs, oracle, name)
    assert svc.stats.persist_invalidations >= 1
    assert svc.stats.persist_hits == 0
    assert svc.stats.compiles == 1
    assert svc.stats.persist_stores == 1
    svc2 = service(db, d)
    assert_identical(svc2.execute(ALL[name]).raw, raws[name], name)
    assert svc2.stats.compiles == 0 and svc2.stats.persist_hits == 1


def test_mismatched_fingerprint_never_served(db, oracle, warm_cache,
                                             tmp_path, monkeypatch):
    """A cache written under another torch version is invalidated and
    recompiled, never loaded."""
    d0, raws = warm_cache
    d = str(tmp_path / "foreign")
    shutil.copytree(d0, d)
    real = persist.env_fingerprint

    def foreign(*args):
        fp = real(*args)
        fp["torch"] = "0.0.0-foreign"
        return fp

    monkeypatch.setattr(persist, "env_fingerprint", foreign)
    svc = service(db, d)
    name = TEMPLATES[0]
    rs = svc.execute(ALL[name])
    assert_identical(rs.raw, raws[name], name)
    check(rs, oracle, name)
    assert svc.stats.persist_hits == 0
    assert svc.stats.persist_invalidations == 1
    assert svc.stats.compiles == 1


def test_kernel_sources_are_fingerprinted(db, warm_cache, tmp_path,
                                          monkeypatch):
    """A change to a CUDA kernel source changes what a plan computes on
    the card without changing its signature or config: the digest of
    ``kernels/csrc`` must catch it."""
    d0, raws = warm_cache
    d = str(tmp_path / "csrc_env")
    shutil.copytree(d0, d)
    src = tmp_path / "csrc"
    shutil.copytree(persist.CSRC_DIR, src)
    before = persist.csrc_digest()
    monkeypatch.setattr(persist, "CSRC_DIR", src)
    assert persist.csrc_digest() == before
    with open(src / "hash_join.cu", "a") as fh:
        fh.write("\n// edited\n")
    assert persist.csrc_digest() != before
    svc = service(db, d)
    name = TEMPLATES[0]
    assert_identical(svc.execute(ALL[name]).raw, raws[name], name)
    assert svc.stats.persist_hits == 0
    assert svc.stats.persist_invalidations == 1


def test_entry_of_another_plan_is_invalidated(db, warm_cache, tmp_path):
    """An entry whose stored plan is not the plan asked for (here: Q11's
    entry under Q2's key) is deleted and recompiled."""
    d0, raws = warm_cache
    d = str(tmp_path / "swapped")
    shutil.copytree(d0, d)
    svc = service(db, d)
    pq2, pq11 = svc.prepare(ALL["Q2"]), svc.prepare(ALL["Q11"])
    key2 = persist.entry_key(pq2.signature, svc.compiled(
        pq2.plan, svc._presized_config(pq2.plan), sig=pq2.signature,
        param_specs=pq2.specs).config, "sim", 4, None)
    cache = persist.PlanDiskCache(d)
    _, entry = cache.lookup(key2, svc._fingerprint)
    entry["plan"] = pq11.plan
    cache.store(key2, svc._fingerprint, {k: v for k, v in entry.items()
                                         if k not in ("key",
                                                      "fingerprint")})
    svc2 = service(db, d)
    assert_identical(svc2.execute(ALL["Q2"]).raw, raws["Q2"], "Q2")
    assert svc2.stats.persist_hits == 0
    assert svc2.stats.persist_invalidations == 1
    assert svc2.stats.compiles == 1


def test_max_bytes_prunes_oldest(db, tmp_path):
    d = str(tmp_path / "bounded")
    svc = service(db, d)
    svc.execute(ALL["Q2"])
    one = svc.persist_info().bytes
    assert one > 0
    svc2 = service(db, d, persist_max_bytes=int(one * 1.5))
    svc2.execute(ALL["Q2"])                 # disk hit, no store
    svc2.execute(ALL["Q4"])                 # store -> prune Q2's entry
    assert svc2.stats.persist_stores == 1
    assert svc2.stats.evictions_by_cache.get("persist", 0) >= 1
    assert svc2.persist_info().bytes <= int(one * 1.5)


def test_disk_roundtrip_unit(tmp_path):
    """PlanDiskCache without a service: miss -> store -> hit; a wrong
    fingerprint -> invalid AND deleted."""
    c = persist.PlanDiskCache(str(tmp_path / "unit"))
    fp = {"v": 1}
    assert c.lookup("k" * 64, fp) == ("miss", None)
    entry = {"schema": {0: ("num", None)}, "plan": None, "config": None,
             "param_specs": (), "batch": None}
    assert c.store("k" * 64, fp, entry) == 0
    status, got = c.lookup("k" * 64, fp)
    assert status == "hit" and got["schema"] == {0: ("num", None)}
    assert c.lookup("k" * 64, {"v": 2})[0] == "invalid"
    assert c.lookup("k" * 64, fp) == ("miss", None)
    assert c.info().entries == 0


def test_negative_max_bytes_is_refused(db):
    with pytest.raises(InvalidArgumentError):
        QueryService(db, persist_max_bytes=-1, device="cpu")
