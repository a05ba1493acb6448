"""Kernels of the PyTorch port: each plain version against the JAX
package's Pallas kernel (interpret mode, as tests/test_kernels.py and
tests/test_seg_kernels.py run it), on the same seeded numpy inputs with
a leading partition dimension; then, on a CUDA device only, each CUDA
kernel against its plain version.

Tolerances: everything is exact except float sums, held to rtol=1e-5
(the reference's own kernel and jnp twin disagree on sum bits, see
test_seg_kernels.py[256-32-256-1]; sums here run in another order), and
attention: atol/rtol 2e-5 in float32 for the plain versions against the
Pallas kernels (as tests/test_kernels.py holds the kernels to their jnp
references); on the card 1e-4 in float32 (another summation order over
up to 2048 keys) and 2e-2 in bfloat16 (outputs rounded to bf16, one ulp
of values below 4 is at most 1.6e-2).

The JAX imports sit inside the JAX-parity tests so that the CUDA cases
also run where JAX is not installed:
    python -m pytest -q --noconftest tests/test_torch_kernels.py -k cuda
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import (decode_attention, flash_attention,
                                 hash_join, ops, ref, seg_aggregate, seg_topk)
from repro_torch.kernels.registry import KERNELS, NOT_PORTED

SUM_RTOL = 1e-5
ATT_TOL = 2e-5                                    # plain vs Pallas, f32
CUDA_ATT_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


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


def attn_case(bh, bhkv, sq, sk, d, seed):
    """Standard-normal q (BH, Sq, D), k/v (BHkv, Sk, D), float32."""
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((bh, sq, d), (bhkv, sk, d), (bhkv, sk, d)))


def decode_case(bh, g, sk, d, seed):
    """q (BH, G, D), k/v (BH, Sk, D) float32; kv_len drawn later."""
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((bh, g, d), (bh, sk, d), (bh, sk, d)))


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


def test_registry_covers_every_tpu_kernel():
    from repro.kernels.registry import KERNEL_REFS
    assert {e["jax_ref"] for e in KERNELS.values()} == set(KERNEL_REFS)
    assert len(KERNELS) == len(KERNEL_REFS) == 6
    assert NOT_PORTED == {}
    for e in KERNELS.values():
        assert e["plain"] == KERNEL_REFS[e["jax_ref"]]


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
                                             (257, 40, False),
                                             # just past a power of two
                                             (129, 1, True), (129, 129, True)])
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


@pytest.mark.parametrize("causal,window,softcap,g,sq,sk,d", [
    (True, None, None, 2, 128, 128, 64),
    (True, 64, None, 2, 128, 128, 64),
    (True, None, 30.0, 1, 64, 256, 32),
    (False, None, None, 4, 256, 128, 32),
    (True, 64, 30.0, 2, 128, 128, 64),
    (False, 16, 50.0, 8, 64, 128, 16),
])
def test_flash_attention_plain_vs_pallas(causal, window, softcap, g, sq, sk,
                                         d):
    import jax.numpy as jnp
    from repro.kernels.flash_attention import flash_attention_bhsd as jax_fa
    q, k, v = attn_case(2 * g, 2, sq, sk, d, seed=sq + sk + d + g)
    want = jax_fa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), g=g,
                  causal=causal, window=window, softcap=softcap,
                  block_q=64, block_k=64, interpret=True)
    got = ref.flash_attention(T(q), T(k), T(v), g=g, causal=causal,
                              window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATT_TOL,
                               rtol=ATT_TOL)


@pytest.mark.parametrize("g,sk,d,window,softcap", [
    (4, 256, 64, None, None), (8, 512, 128, None, None),
    (1, 128, 32, None, None), (4, 256, 64, 32, 25.0), (2, 192, 16, 7, None),
])
def test_decode_attention_plain_vs_pallas(g, sk, d, window, softcap):
    import jax.numpy as jnp
    from repro.kernels.decode_attention import \
        decode_attention_bhgd as jax_dec
    q, k, v = decode_case(4, g, sk, d, seed=g + sk + d)
    kv_len = np.asarray([1, sk // 3, sk - 5, sk], np.int32)   # ragged
    want = jax_dec(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(kv_len), window=window, softcap=softcap,
                   block_k=64, interpret=True)
    got = ref.decode_attention(T(q), T(k), T(v), T(kv_len), window=window,
                               softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATT_TOL,
                               rtol=ATT_TOL)


# ---------------------------------------------------------------------------
# dispatch: the CPU takes the plain version; the kernels take CUDA only
# ---------------------------------------------------------------------------

def test_ops_attention_dispatch_plain_on_cpu():
    """The public (B, S, H, D) entry points on the CPU equal the plain
    versions in the JAX kernels' layouts, and launch nothing."""
    b, sq, hq, hkv, d = 2, 24, 4, 2, 16
    rng = np.random.default_rng(11)
    q = rng.normal(size=(b, sq, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, sq, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, sq, hkv, d)).astype(np.float32)
    got = ops.flash_attention(T(q), T(k), T(v), causal=True, window=5)
    want = ref.flash_attention(
        T(q.transpose(0, 2, 1, 3).reshape(b * hq, sq, d)),
        T(k.transpose(0, 2, 1, 3).reshape(b * hkv, sq, d)),
        T(v.transpose(0, 2, 1, 3).reshape(b * hkv, sq, d)),
        g=hq // hkv, causal=True, window=5)
    assert got.shape == (b, sq, hq, d)
    torch.testing.assert_close(got, want.reshape(b, hq, sq, d)
                               .transpose(1, 2), rtol=0, atol=0)
    kv_len = np.asarray([3, 24], np.int32)
    got = ops.decode_attention(T(q[:, :1]), T(k), T(v), T(kv_len),
                               logit_softcap=20.0)
    g = hq // hkv
    want = ref.decode_attention(
        T(q[:, 0].reshape(b * hkv, g, d)),
        T(k.transpose(0, 2, 1, 3).reshape(b * hkv, sq, d)),
        T(v.transpose(0, 2, 1, 3).reshape(b * hkv, sq, d)),
        T(np.repeat(kv_len, hkv)), softcap=20.0)
    torch.testing.assert_close(got, want.reshape(b, 1, hq, d), rtol=0, atol=0)
    vals = rng.normal(size=(2, 50)).astype(np.float32)
    segs = rng.integers(-1, 9, (2, 50)).astype(np.int32)
    valid = rng.random((2, 50)) > 0.3
    for g_, w_ in zip(ops.segmented_sum_count(T(vals), T(segs), T(valid), 7),
                      ref.segmented_sum_count(T(vals), T(segs), T(valid), 7)):
        assert torch.equal(g_, w_)
    assert flash_attention.flash_attention_bhsd.launches == 0
    assert decode_attention.decode_attention_bhgd.launches == 0
    assert seg_aggregate.segmented_sum_count.launches == 0


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
    with pytest.raises(ValueError, match="CUDA"):
        seg_aggregate.segmented_sum_count(T(vals[..., 0]), T(segs), T(valid),
                                          3)
    q, k, v = attn_case(2, 1, 8, 8, 64, seed=9)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention_bhsd(T(q), T(k), T(v), g=2)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention.decode_attention_bhgd(T(q[:1, :2]), T(k), T(v),
                                               T(np.asarray([3], np.int32)))


@pytest.mark.parametrize("n,nkeys,want", [(1, 3, 2), (33, 1, 64),
                                          (2000, 3, 2048), (8193, 3, 8192),
                                          (50000, 4, 4096), (50000, 32, 512)])
def test_segment_topk_chunk_rows(n, nkeys, want):
    """A power of two that covers N where it can, whose records (nkeys
    words and the row position, in whole 16-byte vectors) fit the
    kernel's shared-memory budget."""
    chunk = seg_topk.chunk_rows(n, nkeys)
    assert chunk == want and chunk & (chunk - 1) == 0
    assert chunk * 16 * ((nkeys + 4) // 4) <= seg_topk.SORT_SMEM


def test_flash_strides_for_the_tma_maps():
    """bf16 strides must be multiples of 8 elements (16 bytes) for the
    tensor-core kernel's TMA maps, float32 ones of 4."""
    for dtype, elems in ((torch.float32, 4), (torch.bfloat16, 8)):
        x = torch.zeros(2, 10, 68, dtype=dtype)[..., :64]   # row stride 68
        if elems == 4:
            flash_attention.check_strided("t", x, elems=elems)
        else:
            with pytest.raises(ValueError, match="multiples of 8"):
                flash_attention.check_strided("t", x, elems=elems)


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


@pytest.mark.parametrize("p,n,cap,float_key,none_valid", [
    (4, 2000, 16, True, False), (2, 1500, 1500, True, False),
    (3, 33, 5, False, False),
    # N over several sorted chunks: the merge runs
    (2, 50000, 64, True, False), (2, 12000, 12000, True, False),
    (3, 20000, 100, True, True)])
def test_cuda_segment_topk(cuda, p, n, cap, float_key, none_valid):
    keys = topk_case(p, n, seed=n, float_key=float_key)
    if none_valid:
        keys = (np.ones_like(keys[0]),) + keys[1:]
    keys = tuple(T(k, cuda) for k in keys)
    got = seg_topk.segment_topk(keys, cap)
    want = ref.segment_topk(keys, cap)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


FLASH_CUDA_CASES = [
    # causal, window, softcap, g, sq, sk, d
    (True, None, None, 2, 256, 256, 128),
    (False, None, None, 1, 100, 77, 64),          # ragged Sq and Sk
    (True, 4096, None, 2, 300, 300, 128),
    (True, 16, None, 8, 130, 200, 64),
    (False, 16, None, 1, 200, 100, 64),           # rows with no live key
    (True, None, 50.0, 2, 129, 129, 256),
    (True, 16, 50.0, 1, 65, 65, 128),
    # the bf16 tensor-core tiling: 128 query rows, 128 keys (64 at D = 256)
    (True, None, None, 2, 1000, 1000, 128),       # no tile multiple
    (True, None, None, 2, 100, 300, 128),         # Sq < Sk
    (True, 100, None, 2, 700, 700, 128),          # window across key tiles
    (True, None, None, 1, 640, 640, 64),
    (True, None, None, 2, 600, 600, 256),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window,softcap,g,sq,sk,d", FLASH_CUDA_CASES)
def test_cuda_flash_attention(cuda, dtype, causal, window, softcap, g, sq, sk,
                              d):
    q, k, v = (T(x, cuda).to(dtype) for x in
               attn_case(2 * g, 2, sq, sk, d, seed=sq * sk + d))
    kw = dict(g=g, causal=causal, window=window, softcap=softcap)
    got = flash_attention.flash_attention_bhsd(q, k, v, **kw)
    want = ref.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    tol = CUDA_ATT_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    again = flash_attention.flash_attention_bhsd(q, k, v, **kw)
    assert torch.equal(again, got)                 # no atomics, fixed order


def test_cuda_flash_attention_reads_model_layout_in_place(cuda):
    """(B, S, H, D) tensors through ops: strided views, no copies; the
    output comes back contiguous in (B, S, H, D)."""
    b, s, hq, hkv, d = 2, 190, 8, 4, 128
    rng = np.random.default_rng(5)
    q, k, v = (T(rng.normal(size=(b, s, h, d)).astype(np.float32),
                 cuda).bfloat16() for h in (hq, hkv, hkv))
    got = ops.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention(
        q.transpose(1, 2).reshape(b * hq, s, d),
        k.transpose(1, 2).reshape(b * hkv, s, d),
        v.transpose(1, 2).reshape(b * hkv, s, d), g=2, causal=True)
    torch.cuda.synchronize()
    assert got.is_contiguous() and got.shape == (b, s, hq, d)
    torch.testing.assert_close(got.float(), want.reshape(b, hq, s, d)
                               .transpose(1, 2).float(), atol=2e-2, rtol=2e-2)


DECODE_CUDA_CASES = [
    # g, smax, d, window, softcap
    (2, 2080, 128, None, None),
    (1, 1000, 64, None, None),
    (8, 333, 256, None, 50.0),
    (4, 2080, 128, 16, None),
    (2, 65, 128, 4096, 30.0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,smax,d,window,softcap", DECODE_CUDA_CASES)
def test_cuda_decode_attention(cuda, dtype, g, smax, d, window, softcap):
    q, k, v = (T(x, cuda).to(dtype) for x in
               decode_case(6, g, smax, d, seed=smax + d + g))
    kv_len = T(np.asarray([1, 2, smax // 2 + 3, smax - 1, smax, 0],
                          np.int32), cuda)   # 0: no live slot
    kw = dict(window=window, softcap=softcap)
    got = decode_attention.decode_attention_bhgd(q, k, v, kv_len, **kw)
    want = ref.decode_attention(q, k, v, kv_len, **kw)
    torch.cuda.synchronize()
    tol = CUDA_ATT_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    again = decode_attention.decode_attention_bhgd(q, k, v, kv_len, **kw)
    assert torch.equal(again, got)                 # fixed combine order


def test_cuda_decode_attention_reads_cache_in_place(cuda):
    b, smax, hq, hkv, d = 3, 2080, 16, 8, 128
    rng = np.random.default_rng(6)
    q = T(rng.normal(size=(b, 1, hq, d)).astype(np.float32), cuda).bfloat16()
    kc, vc = (T(rng.normal(size=(b, smax, hkv, d)).astype(np.float32),
                cuda).bfloat16() for _ in range(2))
    kv_len = T(np.asarray([7, 2048, 2080], np.int32), cuda)
    got = ops.decode_attention(q, kc, vc, kv_len)
    g = hq // hkv
    want = ref.decode_attention(
        q.reshape(b * hkv, g, d), kc.transpose(1, 2).reshape(b * hkv, smax, d),
        vc.transpose(1, 2).reshape(b * hkv, smax, d),
        torch.repeat_interleave(kv_len, hkv))
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.reshape(b, 1, hq, d).float(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("p,n,s,valid_share", [(4, 5000, 37, 0.8),
                                               (2, 3001, 9000, 0.8),
                                               (3, 999, 4096, 0.0),
                                               (4, 300000, 2000, 0.8)])
def test_cuda_segmented_sum_count(cuda, p, n, s, valid_share):
    rng = np.random.default_rng(n + s)
    vals = (rng.integers(-400, 400, (p, n)) / 10.0).astype(np.float32)
    segs = rng.integers(-3, s + 3, (p, n)).astype(np.int32)
    valid = rng.random((p, n)) < valid_share
    args = (T(vals, cuda), T(segs, cuda), T(valid, cuda), s)
    sums, counts = seg_aggregate.segmented_sum_count(*args)
    wsums, wcounts = ref.segmented_sum_count(*args)
    mag, _ = ref.segmented_sum_count(args[0].abs(), *args[1:])
    torch.cuda.synchronize()
    assert torch.equal(counts, wcounts)
    assert bool(((sums - wsums).abs() <= SUM_RTOL * mag + 1e-30).all())
    again, _ = seg_aggregate.segmented_sum_count(*args)
    assert torch.equal(again, sums)
