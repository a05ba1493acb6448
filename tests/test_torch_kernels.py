"""Kernels of the PyTorch port: each plain version against the JAX
package's Pallas kernel (interpret mode, as tests/test_kernels.py and
tests/test_seg_kernels.py run it), on the same seeded numpy inputs with
a leading partition dimension; then, on a CUDA device only, each CUDA
kernel against its plain version.

Tolerances: everything is exact except float sums, held to rtol=1e-5
(the reference's own kernel and jnp twin disagree on sum bits, see
test_seg_kernels.py[256-32-256-1]; sums here run in another order).

The JAX imports sit inside the JAX-parity tests so that the CUDA cases
also run where JAX is not installed:
    python -m pytest -q --noconftest tests/test_torch_kernels.py -k cuda
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import hash_join, ops, ref, seg_aggregate, seg_topk
from repro_torch.kernels.registry import KERNELS, NOT_PORTED

SUM_RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# seeded inputs, numpy, [P, ...]
# ---------------------------------------------------------------------------

def join_case(p, nb, np_, nkeys, seed):
    """Build keys with duplicates, probe keys that mostly hit, ~15 %
    invalid rows on both sides."""
    rng = np.random.default_rng(seed)
    bk = [rng.integers(0, nb // 2 + 1, (p, nb)).astype(np.int32)]
    pk = [rng.integers(0, nb // 2 + 20, (p, np_)).astype(np.int32)]
    if nkeys == 2:
        bk.append(rng.integers(-3, 3, (p, nb)).astype(np.int32))
        pk.append(rng.integers(-3, 3, (p, np_)).astype(np.int32))
    return (tuple(bk), rng.random((p, nb)) > 0.15,
            tuple(pk), rng.random((p, np_)) > 0.15)


def agg_case(p, n, s, nc, seed):
    """Weather-like values in tenths, NaNs masked out through ``ok``,
    invalid rows, segment ids outside [0, S)."""
    rng = np.random.default_rng(seed)
    vals = (rng.integers(-400, 400, (p, n, nc)) / 10.0).astype(np.float32)
    vals[rng.random((p, n, nc)) < 0.05] = np.nan
    ok = (rng.random((p, n, nc)) > 0.1) & ~np.isnan(vals)
    segs = rng.integers(-1, s + 2, (p, n)).astype(np.int32)
    valid = rng.random((p, n)) > 0.2
    return vals, ok, segs, valid


def topk_case(p, n, seed, float_key=True):
    """flag, a tie-heavy float key (negated: -0.0 appears), an int key."""
    rng = np.random.default_rng(seed)
    valid = rng.random((p, n)) > 0.3
    flag = (~valid).astype(np.int32)
    f = rng.integers(-3, 4, (p, n)).astype(np.float32)
    f[(f == 0) & (rng.random((p, n)) < 0.5)] = np.float32(-0.0)
    i = rng.integers(0, 5, (p, n)).astype(np.int32)
    keys = [flag, f if float_key else f.astype(np.int32), i]
    return tuple(keys)


def T(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_registry_entries_resolve():
    from repro.kernels.registry import KERNEL_REFS
    for name, e in KERNELS.items():
        mod, fn = e["wrapper"].split(".")
        wrapper = getattr(importlib.import_module(
            f"repro_torch.kernels.{mod}"), fn)
        assert callable(wrapper) and hasattr(wrapper, "launches"), name
        assert callable(getattr(ref, e["plain"])), name
        assert e["jax_ref"] in KERNEL_REFS, name
    # every JAX kernel is either ported or listed as still to port
    ported = {e["jax_ref"] for e in KERNELS.values()}
    assert ported | set(NOT_PORTED) == set(KERNEL_REFS)


# ---------------------------------------------------------------------------
# plain versions vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nb,np_,nkeys", [(128, 256, 1), (200, 130, 2),
                                          (512, 300, 2)])
def test_block_join_probe_plain_vs_pallas(nb, np_, nkeys):
    import jax.numpy as jnp
    from repro.kernels.hash_join import block_join_probe as jax_probe
    bk, bv, pk, pv = join_case(2, nb, np_, nkeys, seed=nb + nkeys)
    want = []
    for p in range(2):
        pos, _ = jax_probe(tuple(jnp.asarray(k[p]) for k in bk),
                           jnp.asarray(bv[p]),
                           tuple(jnp.asarray(k[p]) for k in pk),
                           jnp.asarray(pv[p]), block_p=64, block_b=64,
                           interpret=True)
        want.append(np.asarray(pos))
    pos, matched = ref.block_join_probe(tuple(map(T, bk)), T(bv),
                                        tuple(map(T, pk)), T(pv))
    np.testing.assert_array_equal(pos.numpy(), np.stack(want))
    np.testing.assert_array_equal(matched.numpy(), np.stack(want) >= 0)


@pytest.mark.parametrize("n,s,nc,bn", [(512, 16, 2, 128), (256, 32, 1, 256),
                                       (384, 7, 3, 128), (256, 8, 0, 128)])
def test_segmented_aggregate_plain_vs_pallas(n, s, nc, bn):
    import jax.numpy as jnp
    from repro.kernels.seg_aggregate import segmented_aggregate as jax_agg
    vals, ok, segs, valid = agg_case(2, n, s, nc, seed=n + s + nc)
    jc = max(nc, 1)     # the Pallas kernel needs a column; C=0 uses one
    want = [[] for _ in range(4)]
    for p in range(2):
        jv = vals[p] if nc else np.zeros((n, 1), np.float32)
        jo = ok[p] if nc else np.zeros((n, 1), bool)
        got = jax_agg(jnp.asarray(jv), jnp.asarray(jo), jnp.asarray(segs[p]),
                      jnp.asarray(valid[p]), s, block_n=bn, interpret=True)
        for w, g in zip(want, got):
            w.append(np.asarray(g))
    counts, sums, mins, maxs = ref.segmented_aggregate(
        T(vals), T(ok), T(segs), T(valid), s)
    np.testing.assert_array_equal(counts.numpy(), np.stack(want[0]))
    cut = slice(0, nc) if nc else slice(0, 0)
    assert sums.shape == (2, s, nc) and jc >= nc
    np.testing.assert_allclose(sums.numpy(), np.stack(want[1])[..., cut],
                               rtol=SUM_RTOL)
    np.testing.assert_array_equal(mins.numpy(), np.stack(want[2])[..., cut])
    np.testing.assert_array_equal(maxs.numpy(), np.stack(want[3])[..., cut])


@pytest.mark.parametrize("n,cap,float_key", [(300, 16, True), (128, 128, True),
                                             (257, 40, False)])
def test_segment_topk_plain_vs_pallas(n, cap, float_key):
    import jax.numpy as jnp
    from repro.kernels.seg_topk import segment_topk as jax_topk
    keys = topk_case(2, n, seed=n + cap, float_key=float_key)
    want = np.stack([np.asarray(jax_topk(
        tuple(jnp.asarray(k[p]) for k in keys), cap, interpret=True))
        for p in range(2)])
    got = ref.segment_topk(tuple(map(T, keys)), cap)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,s", [(512, 32), (1024, 7)])
def test_segmented_sum_count_plain_vs_pallas(n, s):
    import jax.numpy as jnp
    from repro.kernels.seg_aggregate import segmented_sum_count as jax_ssc
    rng = np.random.default_rng(n + s)
    vals = rng.normal(size=(2, n)).astype(np.float32)
    segs = rng.integers(-1, s + 2, (2, n)).astype(np.int32)
    valid = rng.random((2, n)) > 0.25
    want = [jax_ssc(jnp.asarray(vals[p]), jnp.asarray(segs[p]),
                    jnp.asarray(valid[p]), s, block_n=128, interpret=True)
            for p in range(2)]
    sums, counts = ref.segmented_sum_count(T(vals), T(segs), T(valid), s)
    np.testing.assert_allclose(sums.numpy(),
                               np.stack([np.asarray(w[0]) for w in want]),
                               rtol=SUM_RTOL, atol=1e-5)
    np.testing.assert_array_equal(counts.numpy(),
                                  np.stack([np.asarray(w[1]) for w in want]))


# ---------------------------------------------------------------------------
# dispatch: the CPU takes the plain version; the kernels take CUDA only
# ---------------------------------------------------------------------------

def test_ops_dispatch_plain_on_cpu():
    bk, bv, pk, pv = join_case(2, 64, 64, 2, seed=3)
    pos, matched, bovf = ops.hash_join_probe(tuple(map(T, bk)), T(bv),
                                             tuple(map(T, pk)), T(pv))
    want, _ = ref.block_join_probe(tuple(map(T, bk)), T(bv),
                                   tuple(map(T, pk)), T(pv))
    assert torch.equal(pos, want) and not bovf.any()
    assert bovf.shape == (2,)
    vals, ok, segs, valid = agg_case(2, 64, 5, 2, seed=4)
    got = ops.segmented_aggregate(T(vals), T(ok), T(segs), T(valid), 5)
    for g, w in zip(got, ref.segmented_aggregate(T(vals), T(ok), T(segs),
                                                 T(valid), 5)):
        assert torch.equal(g.nan_to_num(), w.nan_to_num())
    keys = tuple(map(T, topk_case(2, 50, seed=5)))
    assert torch.equal(ops.segment_topk(keys, 7), ref.segment_topk(keys, 7))
    assert hash_join.block_join_probe.launches == 0
    assert seg_aggregate.segmented_aggregate.launches == 0
    assert seg_topk.segment_topk.launches == 0


def test_kernel_wrappers_refuse_cpu_tensors():
    bk, bv, pk, pv = join_case(1, 8, 8, 1, seed=6)
    with pytest.raises(ValueError, match="CUDA"):
        hash_join.block_join_probe(tuple(map(T, bk)), T(bv),
                                   tuple(map(T, pk)), T(pv))
    vals, ok, segs, valid = agg_case(1, 8, 3, 1, seed=7)
    with pytest.raises(ValueError, match="CUDA"):
        seg_aggregate.segmented_aggregate(T(vals), T(ok), T(segs), T(valid), 3)
    with pytest.raises(ValueError, match="CUDA"):
        seg_topk.segment_topk(tuple(map(T, topk_case(1, 8, seed=8))), 2)


# ---------------------------------------------------------------------------
# CUDA kernels vs their plain versions (skip without a card)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p,nb,np_,nkeys", [(4, 1000, 777, 1),
                                            (4, 2049, 3000, 2),
                                            (1, 5, 1, 2)])
def test_cuda_block_join_probe(cuda, p, nb, np_, nkeys):
    bk, bv, pk, pv = join_case(p, nb, np_, nkeys, seed=nb)
    args = (tuple(T(k, cuda) for k in bk), T(bv, cuda),
            tuple(T(k, cuda) for k in pk), T(pv, cuda))
    pos, matched = hash_join.block_join_probe(*args)
    want, wm = ref.block_join_probe(*args)
    torch.cuda.synchronize()
    assert torch.equal(pos, want) and torch.equal(matched, wm)


@pytest.mark.parametrize("p,n,s,nc", [(4, 5000, 37, 2), (4, 3001, 4500, 3),
                                      (2, 700, 9000, 4), (3, 999, 16, 0)])
def test_cuda_segmented_aggregate(cuda, p, n, s, nc):
    vals, ok, segs, valid = agg_case(p, n, s, nc, seed=n + s)
    args = (T(vals, cuda), T(ok, cuda), T(segs, cuda), T(valid, cuda), s)
    got = seg_aggregate.segmented_aggregate(*args)
    want = ref.segmented_aggregate(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=SUM_RTOL, atol=1e-4,
                               equal_nan=True)
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    again = seg_aggregate.segmented_aggregate(*args)
    assert torch.equal(again[1], got[1])          # deterministic sums


@pytest.mark.parametrize("p,n,cap,float_key", [(4, 2000, 16, True),
                                               (2, 1500, 1500, True),
                                               (3, 33, 5, False)])
def test_cuda_segment_topk(cuda, p, n, cap, float_key):
    keys = tuple(T(k, cuda) for k in topk_case(p, n, seed=n,
                                               float_key=float_key))
    got = seg_topk.segment_topk(keys, cap)
    want = ref.segment_topk(keys, cap)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
