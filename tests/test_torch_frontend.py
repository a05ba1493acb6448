"""Front end of the PyTorch port (parser, translator, rewrite rules —
copies of the JAX package's host-only modules): every query plan and
every diagnostic must be the JAX package's, character for character."""
import pytest

from repro.core import compile_query as jax_compile
from repro.core.algebra import pretty as jax_pretty
from repro.core.queries import ALL
from repro_torch.core import compile_query
from repro_torch.core.algebra import pretty
from repro_torch.core.errors import QueryError


@pytest.mark.parametrize("name", list(ALL))
def test_plan_matches_reference(name):
    assert pretty(compile_query(ALL[name])) == \
        jax_pretty(jax_compile(ALL[name]))


@pytest.mark.parametrize("text", [
    'for $r in collection("/sensors")/dataCollection/data return $r ~',
    'for $r in collection("/sensors")/data where $r/x eq return $r',
    'no-such-function(collection("/sensors"))',
])
def test_diagnostics_match_reference(text):
    from repro.core.errors import QueryError as JaxQueryError
    with pytest.raises(JaxQueryError) as want:
        jax_compile(text)
    with pytest.raises(QueryError) as got:
        compile_query(text)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
