"""The port's baselines against the JAX package's: ``SaxonLike`` (the
tree-walking oracle, copied with its imports renamed) must give the
same rows and scalars on Q1–Q12, and ``MrqlLike`` (the staged
MapReduce stand-in, written in torch: map tasks per partition on the
executor's device, every job boundary on the host) the same rows and
job counts, as tests/test_queries.py holds the JAX one."""
import pytest
import torch
from conftest import check_result

from repro.core import compile_query as jax_compile
from repro.core.baselines import MrqlLike as JaxMrql
from repro.core.baselines import SaxonLike as JaxSaxon
from repro.core.queries import ALL, SCALAR
from repro_torch.core import compile_query, xdm
from repro_torch.core.baselines import MrqlLike, SaxonLike


@pytest.fixture(scope="module")
def db(weather_db):
    return xdm.database_from_arrays(*xdm.database_to_arrays(weather_db))


@pytest.fixture(scope="module")
def mrql(db):
    return MrqlLike(db, device="cpu")


@pytest.fixture(scope="module")
def jax_mrql(weather_db):
    return JaxMrql(weather_db)


@pytest.mark.parametrize("name", list(ALL))
def test_saxon_like_equals_reference(db, weather_db, name):
    got, want = SaxonLike(db), JaxSaxon(weather_db)
    assert got.run_rows(ALL[name]) == want.run_rows(ALL[name])
    if name in SCALAR:
        assert got.run(ALL[name]) == want.run(ALL[name])


@pytest.mark.parametrize("name", list(ALL))
def test_mrql_like_equals_reference(mrql, jax_mrql, oracle, name):
    got = mrql.run(compile_query(ALL[name]))
    want = jax_mrql.run(jax_compile(ALL[name]))
    assert got.rows() == want.rows()
    assert got.jobs == want.jobs >= 1
    assert got.overflow is want.overflow is False
    check_result(got, oracle, name)


def test_mrql_like_defaults_to_cuda(db, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MrqlLike(db)
