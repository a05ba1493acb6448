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
from pathlib import Path

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


I32_MIN, I32_MAX = -2**31, 2**31 - 1


def join_edge_case(kind, p, nb, np_, nkeys, seed):
    """The hash table's worst cases, ~15 % invalid rows on both sides:
    ``equal`` every build key equal; ``miss`` no probe key present;
    ``extreme`` keys at INT32_MIN/INT32_MAX and negative, duplicated;
    ``k0`` k0 equal everywhere, k1 different, and probes that swap
    (k0, k1); ``random`` the duplicate-heavy ``join_case``."""
    if kind == "random":
        return join_case(p, nb, np_, nkeys, seed)
    rng = np.random.default_rng(seed)

    def ints(lo, hi, n):
        return rng.integers(lo, hi, (p, n), endpoint=True).astype(np.int32)

    if kind == "equal":
        bk = [np.full((p, nb), 7, np.int32), np.full((p, nb), -2, np.int32)]
        hit = rng.random((p, np_)) < 0.5
        pk = [np.where(hit, 7, ints(-9, 9, np_)).astype(np.int32),
              np.where(hit, -2, ints(-3, 3, np_)).astype(np.int32)]
    elif kind == "miss":
        bk = [ints(0, nb, nb), ints(-5, 5, nb)]
        pk = [ints(nb + 1, 3 * nb + 1, np_), ints(-5, 5, np_)]
    elif kind == "extreme":
        pool = np.asarray([I32_MIN, I32_MIN + 1, -2, -1, 0, 1, I32_MAX - 1,
                           I32_MAX], np.int32)
        bk = [pool[rng.integers(0, 8, (p, nb))],
              pool[rng.integers(0, 8, (p, nb))]]
        pk = [pool[rng.integers(0, 8, (p, np_))],
              pool[rng.integers(0, 8, (p, np_))]]
        neg = rng.random((p, nb)) < 0.3
        bk[0] = np.where(neg, ints(I32_MIN, -1, nb), bk[0])
        pk[0] = np.where(rng.random((p, np_)) < 0.3,
                         bk[0][:, rng.integers(0, nb, np_)], pk[0])
    elif kind == "k0":
        bk = [np.full((p, nb), 3, np.int32), ints(0, nb, nb)]
        pk = [np.full((p, np_), 3, np.int32), ints(0, 2 * nb, np_)]
        swap = rng.random((p, np_)) < 0.3
        pk = [np.where(swap, pk[1], pk[0]), np.where(swap, pk[0], pk[1])]
    else:
        raise ValueError(kind)
    bk, pk = bk[:nkeys], pk[:nkeys]
    return (tuple(bk), rng.random((p, nb)) > 0.15,
            tuple(pk), rng.random((p, np_)) > 0.15)


def seg_layout(rng, p, n, s, kind, share=0.8):
    """Segment ids and valid flags [P, N] of the aggregate edge cases:
    ``random`` uniform ids in [-1, S + 1] (some outside [0, S)), rows
    valid at ``share``; ``runs`` station-major runs of 97 rows of one id
    (a run crosses the kernels' 4096-row tiles), ids cycling over
    [-1, S], 20 % valid; ``hot`` every valid row in segment 0 but a few
    ids outside [0, S); ``sparse`` the runs with 0.4 % of rows valid, in
    clusters of two (Q12's selection); ``none`` the runs with no row
    valid."""
    if kind == "random":
        segs = rng.integers(-1, s + 2, (p, n)).astype(np.int32)
        return segs, rng.random((p, n)) < share
    rows = np.arange(n)[None, :]
    part = np.arange(p)[:, None]
    segs = ((rows // 97 + 13 * part) % (s + 2) - 1).astype(np.int32)
    valid = rng.random((p, n)) < 0.2
    if kind == "hot":
        segs = np.where(rng.random((p, n)) < 0.02, s, 0).astype(np.int32)
        valid = rng.random((p, n)) < 0.9
    elif kind == "sparse":
        valid = (rows + 7 * part) % 500 < 2
    elif kind == "none":
        valid = np.zeros((p, n), bool)
    elif kind != "runs":
        raise ValueError(kind)
    return segs, valid


def agg_case(p, n, s, nc, seed, kind="random"):
    """Weather-like values in tenths, NaNs masked out through ``ok``,
    then ``seg_layout``'s ids and flags (``random``: invalid rows,
    segment ids outside [0, S))."""
    rng = np.random.default_rng(seed)
    vals = (rng.integers(-400, 400, (p, n, nc)) / 10.0).astype(np.float32)
    vals[rng.random((p, n, nc)) < 0.05] = np.nan
    ok = (rng.random((p, n, nc)) > 0.1) & ~np.isnan(vals)
    if kind == "random":
        segs = rng.integers(-1, s + 2, (p, n)).astype(np.int32)
        valid = rng.random((p, n)) > 0.2
    else:
        segs, valid = seg_layout(rng, p, n, s, kind)
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

def forward_kernels() -> dict:
    """The registry's entries that port a Pallas kernel (a backward has
    none: ``"backward_of"`` names its forward instead)."""
    return {n: e for n, e in KERNELS.items() if "backward_of" not in e}


def test_registry_entries_resolve():
    from repro.kernels.registry import KERNEL_REFS
    for name, e in KERNELS.items():
        mod, fn = e["wrapper"].split(".")
        wrapper = getattr(importlib.import_module(
            f"repro_torch.kernels.{mod}"), fn)
        assert callable(wrapper) and hasattr(wrapper, "launches"), name
        assert callable(getattr(ref, e["plain"])), name
        if "backward_of" in e:
            # a backward names a forward of the registry, and no Pallas
            # kernel
            assert e["backward_of"] in forward_kernels(), name
            assert e["jax_ref"] is None and e["replaces"] is None, name
        else:
            assert e["jax_ref"] in KERNEL_REFS, name
    # every JAX kernel is either ported or listed as still to port
    ported = {e["jax_ref"] for e in forward_kernels().values()}
    assert ported | set(NOT_PORTED) == set(KERNEL_REFS)


def test_registry_covers_every_tpu_kernel():
    from repro.kernels.registry import KERNEL_REFS
    fwd = forward_kernels()
    assert {e["jax_ref"] for e in fwd.values()} == set(KERNEL_REFS)
    assert len(fwd) == len(KERNEL_REFS) == 6
    assert set(KERNELS) - set(fwd) == {"flash_attention_bwd"}
    assert NOT_PORTED == {}
    for e in fwd.values():
        assert e["plain"] == KERNEL_REFS[e["jax_ref"]]


# ---------------------------------------------------------------------------
# plain versions vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

JOIN_EDGES = [
    # kind, nb, np_, nkeys
    ("equal", 300, 200, 2), ("equal", 64, 100, 1), ("miss", 500, 300, 2),
    ("extreme", 400, 300, 2), ("extreme", 257, 129, 1), ("k0", 300, 400, 2),
    ("random", 1, 50, 2),
    # a table-size boundary: 2 NB just past 2^21, so 2^22 slots
    ("random", 2**20 + 3, 256, 1),
]


@pytest.mark.parametrize("kind,nb,np_,nkeys", [
    pytest.param("random", 128, 256, 1, id="128-256-1"),
    pytest.param("random", 200, 130, 2, id="200-130-2"),
    pytest.param("random", 512, 300, 2, id="512-300-2"),
    *[pytest.param(*e, id="-".join(map(str, e))) for e in JOIN_EDGES]])
def test_block_join_probe_plain_vs_pallas(kind, nb, np_, nkeys):
    import jax.numpy as jnp
    from repro.kernels.hash_join import block_join_probe as jax_probe
    p_ = 1 if nb > 2**16 else 2
    bk, bv, pk, pv = join_edge_case(kind, p_, nb, np_, nkeys,
                                    seed=nb + nkeys)
    # large build sides in few interpret-mode grid steps
    block_b = 64 if nb <= 2**12 else 2**17
    want = []
    for p in range(p_):
        pos, _ = jax_probe(tuple(jnp.asarray(k[p]) for k in bk),
                           jnp.asarray(bv[p]),
                           tuple(jnp.asarray(k[p]) for k in pk),
                           jnp.asarray(pv[p]), block_p=64, block_b=block_b,
                           interpret=True)
        want.append(np.asarray(pos))
    pos, matched = ref.block_join_probe(tuple(map(T, bk)), T(bv),
                                        tuple(map(T, pk)), T(pv))
    np.testing.assert_array_equal(pos.numpy(), np.stack(want))
    np.testing.assert_array_equal(matched.numpy(), np.stack(want) >= 0)


@pytest.mark.parametrize("n,s,nc,bn,kind", [
    pytest.param(512, 16, 2, 128, "random", id="512-16-2-128"),
    pytest.param(256, 32, 1, 256, "random", id="256-32-1-256"),
    pytest.param(384, 7, 3, 128, "random", id="384-7-3-128"),
    pytest.param(256, 8, 0, 128, "random", id="256-8-0-128"),
    # sorted runs, one hot segment, 0.4 % valid in clusters
    pytest.param(512, 16, 2, 128, "runs", id="runs-512-16-2-128"),
    pytest.param(384, 7, 3, 128, "hot", id="hot-384-7-3-128"),
    pytest.param(1024, 8, 1, 256, "sparse", id="sparse-1024-8-1-256")])
def test_segmented_aggregate_plain_vs_pallas(n, s, nc, bn, kind):
    import jax.numpy as jnp
    from repro.kernels.seg_aggregate import segmented_aggregate as jax_agg
    vals, ok, segs, valid = agg_case(2, n, s, nc, seed=n + s + nc, kind=kind)
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


@pytest.mark.parametrize("n,s,kind", [
    pytest.param(512, 32, "random", id="512-32"),
    pytest.param(1024, 7, "random", id="1024-7"),
    pytest.param(1024, 16, "runs", id="runs-1024-16"),
    pytest.param(512, 8, "hot", id="hot-512-8"),
    pytest.param(1024, 8, "sparse", id="sparse-1024-8")])
def test_segmented_sum_count_plain_vs_pallas(n, s, kind):
    import jax.numpy as jnp
    from repro.kernels.seg_aggregate import segmented_sum_count as jax_ssc
    rng = np.random.default_rng(n + s)
    vals = rng.normal(size=(2, n)).astype(np.float32)
    if kind == "random":
        segs = rng.integers(-1, s + 2, (2, n)).astype(np.int32)
        valid = rng.random((2, n)) > 0.25
    else:
        segs, valid = seg_layout(rng, 2, n, s, kind)
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


FLASH_LSE_CASES = [
    # causal, window, softcap, g, sq, sk, d: the flash edge shapes
    (True, None, None, 2, 128, 128, 64),
    (True, 64, None, 2, 128, 128, 64),
    (True, None, 30.0, 1, 64, 256, 32),
    (False, None, None, 4, 256, 128, 32),
    (True, 64, 30.0, 2, 128, 128, 64),
    (False, 16, 50.0, 8, 64, 128, 16),
    (False, None, None, 1, 100, 77, 64),           # ragged Sq and Sk
    (True, None, None, 2, 100, 300, 32),           # Sq < Sk
    (False, 16, None, 1, 200, 100, 16),            # rows with no live key
]


@pytest.mark.parametrize("causal,window,softcap,g,sq,sk,d", FLASH_LSE_CASES)
def test_flash_lse_plain_vs_jax_logsumexp(causal, window, softcap, g, sq, sk,
                                          d):
    """``ref.flash_attention(..., return_lse=True)``'s L against
    jax.nn.logsumexp of the masked, scaled, softcapped scores that the JAX
    package's oracle (``repro.kernels.ref.flash_attention``) forms, on
    the rows with a live key; the output is the call without L's."""
    import jax
    import jax.numpy as jnp
    from repro.kernels.ref import NEG_INF as JAX_NEG_INF
    q, k, v = attn_case(2 * g, 2, sq, sk, d, seed=sq + sk + d + g + 1)
    kw = dict(g=g, causal=causal, window=window, softcap=softcap)
    out, lse = ref.flash_attention(T(q), T(k), T(v), return_lse=True, **kw)
    assert lse.dtype == torch.float32 and lse.shape == (2 * g, sq)
    assert torch.equal(out, ref.flash_attention(T(q), T(k), T(v), **kw))
    # the JAX oracle's scores, line by line
    s = jnp.einsum("hqd,hkd->hqk", jnp.asarray(q) * d ** -0.5,
                   jnp.repeat(jnp.asarray(k), g, axis=0))
    if softcap is not None:
        s = jnp.tanh(s / softcap) * softcap
    qp, kp = jnp.arange(sq)[:, None], jnp.arange(sk)[None, :]
    ok = jnp.ones((sq, sk), bool)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > (qp - window)
    want = np.asarray(jax.nn.logsumexp(jnp.where(ok, s, JAX_NEG_INF), -1))
    live = np.asarray(ok.any(axis=1))
    assert live.any()
    np.testing.assert_allclose(lse.numpy()[:, live], want[:, live],
                               atol=1e-5, rtol=1e-5)
    # a row with no live key: NEG_INF, as logsumexp of NEG_INF scores
    assert (lse.numpy()[:, ~live] == ref.NEG_INF).all()


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


def test_flash_head_dim_80_admitted_with_its_own_scale():
    """head_dim 80 (hubert-xlarge) is a kernel path, not a refusal, and
    the kernel gets 80 and the default scale 80 ** -0.5, not the width
    of the padded tiling."""
    assert 80 in flash_attention.HEAD_DIMS
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros(4, 10, 80, dtype=dtype)
        k = torch.zeros(2, 12, 80, dtype=dtype)
        args = flash_attention.launch_args(q, k, k, torch.empty_like(q), g=2,
                                           causal=False)
        b, hq, g, sq, sk, d, _, causal, window, scale, softcap, _ = args[5:]
        assert (b, hq, g, sq, sk, d, causal, window, softcap) == \
            (1, 4, 2, 10, 12, 80, 0, 0, 0.0)
        assert scale == 80 ** -0.5
    with pytest.raises(ValueError, match="head_dim 96"):
        q = torch.zeros(2, 8, 96)
        flash_attention.launch_args(q, q, q, torch.empty_like(q), g=1)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, ("bwd_dq_tc", "bwd_dkdv_tc")),
    (torch.bfloat16, 80, ("bwd_dq_tc", "bwd_dkdv_tc")),
    (torch.bfloat16, 128, ("bwd_dq_tc", "bwd_dkdv_tc")),
    (torch.bfloat16, 256, ("bwd_dq_tc", "bwd_dkdv_tc")),
    (torch.float32, 64, ("bwd_dq", "bwd_dkdv")),
    (torch.float32, 128, ("bwd_dq", "bwd_dkdv")),
    (torch.float32, 256, ("bwd_dq", "bwd_dkdv")),
])
def test_flash_bwd_kernels_by_dtype_and_head_dim(dtype, d, want):
    """Which two kernels a backward launches: bf16 at every head_dim on
    the tensor cores, float32 at every head_dim on the FP32 cores; each
    name a ``__global__`` function of the source."""
    got = flash_attention.bwd_kernels(dtype, d)
    assert got == want
    src = (Path(flash_attention.__file__).with_name("csrc")
           / "flash_attention_bwd.cu").read_text()
    for name in got:
        assert f"\n{name}(" in src, name


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

@pytest.mark.parametrize("kind,p,nb,np_,nkeys", [
    pytest.param("random", 4, 1000, 777, 1, id="4-1000-777-1"),
    pytest.param("random", 4, 2049, 3000, 2, id="4-2049-3000-2"),
    pytest.param("random", 1, 5, 1, 2, id="1-5-1-2"),
    *[pytest.param(k, 2, nb, np_, nk, id=f"{k}-2-{nb}-{np_}-{nk}")
      for k, nb, np_, nk in JOIN_EDGES],
    pytest.param("equal", 4, 200000, 50000, 2, id="equal-4-200000-50000-2"),
    pytest.param("random", 2, 0, 300, 2, id="random-2-0-300-2")])
def test_cuda_block_join_probe(cuda, kind, p, nb, np_, nkeys):
    bk, bv, pk, pv = join_edge_case(kind, p, nb, np_, nkeys, seed=nb)
    args = (tuple(T(k, cuda) for k in bk), T(bv, cuda),
            tuple(T(k, cuda) for k in pk), T(pv, cuda))
    pos, matched = hash_join.block_join_probe(*args)
    want, wm = ref.block_join_probe(*args)
    torch.cuda.synchronize()
    assert torch.equal(pos, want) and torch.equal(matched, wm)
    assert torch.equal(hash_join.block_join_probe(*args)[0], pos)


def test_join_table_slots():
    """A power of two >= 2 NB (load factor <= 1/2), from NB alone."""
    assert [hash_join.table_slots(n) for n in (0, 1, 2, 3, 5)] == \
        [0, 2, 4, 8, 16]
    assert hash_join.table_slots(800000) == 2**21
    assert hash_join.table_slots(2**20) == 2**21
    assert hash_join.table_slots(2**20 + 3) == 2**22


AGG_EDGES = [
    # kind, P, N, S, C: station-major runs with N no multiple of 16 (the
    # flag vectors) and runs across tiles; one hot segment; Q12-like 0.4 %
    # valid; S = 1; N below a warp; no row valid; runs at a large S (the
    # global accumulator); C = 5 (the runtime column count)
    ("runs", 4, 100003, 2000, 3), ("hot", 2, 50000, 64, 2),
    ("sparse", 4, 200000, 2000, 3), ("runs", 2, 9000, 1, 1),
    ("runs", 3, 33, 5, 4), ("none", 3, 5000, 37, 2),
    ("runs", 2, 300000, 9000, 4), ("random", 2, 3000, 50, 5)]


@pytest.mark.parametrize("p,n,s,nc,kind", [
    pytest.param(4, 5000, 37, 2, "random", id="4-5000-37-2"),
    pytest.param(4, 3001, 4500, 3, "random", id="4-3001-4500-3"),
    pytest.param(2, 700, 9000, 4, "random", id="2-700-9000-4"),
    pytest.param(3, 999, 16, 0, "random", id="3-999-16-0"),
    *[pytest.param(p, n, s, nc, k, id=f"{k}-{p}-{n}-{s}-{nc}")
      for k, p, n, s, nc in AGG_EDGES]])
def test_cuda_segmented_aggregate(cuda, p, n, s, nc, kind):
    vals, ok, segs, valid = agg_case(p, n, s, nc, seed=n + s, kind=kind)
    args = (T(vals, cuda), T(ok, cuda), T(segs, cuda), T(valid, cuda), s)
    got = seg_aggregate.segmented_aggregate(*args)
    want = ref.segmented_aggregate(*args)
    mag = ref.segmented_aggregate(args[0].abs(), *args[1:])[1]
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    # every sum within SUM_RTOL of the sum of its values' magnitudes (the
    # float-sum error bound, as chip_smoke.check_agg holds it); the
    # uniform-id inputs are also held to rtol on the sum itself. The hot
    # segment's sum of ~45000 signed values cancels to ~1/1000 of their
    # magnitudes, where two summation orders differ by more than that.
    assert bool(((got[1] - want[1]).abs() <= SUM_RTOL * mag + 1e-30).all())
    if kind == "random":
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window,softcap,g,sq,sk,d", FLASH_CUDA_CASES
                         + [(True, 100, 50.0, 2, 300, 300, 80)])
def test_cuda_flash_attention_lse(cuda, dtype, causal, window, softcap, g,
                                  sq, sk, d):
    """The forward kernel's L against the plain L (1e-4 in float32; in
    bf16 2e-3 of max(1, |L|): the kernel's scores come from bf16 products
    and ex2.approx), and O the same bits with L stored and not."""
    q, k, v = (T(x, cuda).to(dtype) for x in
               attn_case(2 * g, 2, sq, sk, d, seed=sq * sk + d + 2))
    kw = dict(g=g, causal=causal, window=window, softcap=softcap)
    o, lse = flash_attention.flash_attention_bhsd(q, k, v, return_lse=True,
                                                  **kw)
    plain = flash_attention.flash_attention_bhsd(q, k, v, **kw)
    _, want = ref.flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:-1]
    assert torch.equal(o, plain)
    tol = 1e-4 if dtype == torch.float32 else 2e-3
    torch.testing.assert_close(lse, want, atol=tol, rtol=tol)


def kernel_names(fn) -> set:
    """The CUDA kernels ``fn`` launches, by the profiler's names."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA}


@pytest.mark.parametrize("dtype,d", [
    (torch.bfloat16, 64), (torch.bfloat16, 80), (torch.bfloat16, 128),
    (torch.bfloat16, 256), (torch.float32, 128)])
def test_cuda_flash_bwd_runs_its_stated_kernels(cuda, dtype, d):
    """Each (dtype, head_dim) reaches the two kernels ``bwd_kernels``
    names and no other of the source."""
    q, k, v = (T(x, cuda).to(dtype) for x in
               attn_case(4, 2, 130, 130, d, seed=d))
    do = torch.ones_like(q)
    o, lse = flash_attention.flash_attention_bhsd(q, k, v, g=2,
                                                  return_lse=True)
    names = kernel_names(lambda: flash_attention.flash_attention_bwd_bhsd(
        q, k, v, o, do, lse, g=2))
    want = flash_attention.bwd_kernels(dtype, d)
    ran = {n for n in ("bwd_dq_tc", "bwd_dkdv_tc", "bwd_dq", "bwd_dkdv")
           if any(f"{n}<" in x or f"{n}(" in x for x in names)}
    assert ran == set(want), names


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window,softcap,g,sq,sk", [
    (False, None, None, 1, 256, 256),             # hubert-xlarge's kind
    (True, None, None, 2, 300, 300),
    (True, 100, 50.0, 2, 700, 700),               # window and softcap
    (False, None, None, 2, 100, 77),              # ragged Sq and Sk
    (True, None, None, 1, 100, 300),              # Sq < Sk
])
def test_cuda_flash_attention_head_dim_80(cuda, dtype, causal, window,
                                          softcap, g, sq, sk):
    """head_dim 80 on the 128-wide tiling (zero-padded in shared memory)
    against the plain version at D = 80."""
    q, k, v = (T(x, cuda).to(dtype) for x in
               attn_case(2 * g, 2, sq, sk, 80, seed=sq * sk + 80))
    kw = dict(g=g, causal=causal, window=window, softcap=softcap)
    got = flash_attention.flash_attention_bhsd(q, k, v, **kw)
    want = ref.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    tol = CUDA_ATT_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


FLASH_BWD_CUDA_CASES = [
    # causal, window, softcap, g, sq, sk, d
    (True, None, None, 2, 256, 256, 128),
    (False, None, None, 1, 100, 77, 64),          # ragged Sq and Sk
    (True, 4096, None, 2, 300, 300, 128),
    (True, 16, None, 8, 130, 200, 64),
    (False, 16, None, 1, 200, 100, 64),           # rows with no live key
    (True, 100, None, 2, 300, 300, 128),          # window across key tiles
    (True, None, 50.0, 2, 129, 129, 256),
    (True, 16, 50.0, 1, 65, 65, 128),
    (True, None, None, 2, 100, 300, 128),         # Sq < Sk
    (True, 100, 50.0, 2, 300, 300, 80),
    (False, None, None, 2, 100, 77, 80),
    # the tensor-core tiling: 128 query rows / 64 keys (dQ), 128 keys /
    # 64 query rows (dK, dV); g = 1, 2, 4, rows with no live key
    (True, None, None, 4, 1000, 1000, 128),       # no tile multiple
    (False, 16, None, 4, 300, 130, 128),          # rows with no live key
    (True, None, None, 1, 200, 200, 80),
    (False, 8, 30.0, 1, 333, 200, 80),
    # head_dim 256: 32-key tiles for dQ, 64 keys a CTA for dK, dV with the
    # warpgroups splitting the columns
    (True, None, 50.0, 2, 1000, 1000, 256),      # no tile multiple, softcap
    (True, None, None, 1, 100, 300, 256),         # Sq < Sk, g = 1
    (True, 100, None, 2, 700, 700, 256),          # window across key tiles
    (False, 8, 30.0, 2, 333, 200, 256),           # rows with no live key
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window,softcap,g,sq,sk,d",
                         FLASH_BWD_CUDA_CASES)
def test_cuda_flash_attention_bwd(cuda, dtype, causal, window, softcap, g,
                                  sq, sk, d):
    """dQ, dK, dV of the backward kernel, given the forward kernel's
    output and L, against the plain backward on that output (L
    recomputed); the same bits on a second launch."""
    q, k, v = (T(x, cuda).to(dtype) for x in
               attn_case(2 * g, 2, sq, sk, d, seed=sq * sk + d + 1))
    do = T(np.random.default_rng(sq + d).normal(size=q.shape)
           .astype(np.float32), cuda).to(dtype)
    kw = dict(g=g, causal=causal, window=window, softcap=softcap)
    o, lse = flash_attention.flash_attention_bhsd(q, k, v, return_lse=True,
                                                  **kw)
    got = flash_attention.flash_attention_bwd_bhsd(q, k, v, o, do, lse, **kw)
    want = ref.flash_attention_bwd(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    tol = CUDA_ATT_TOL[dtype]
    for a, b, x in zip(got, want, (q, k, v)):
        assert a.dtype == dtype and a.shape == x.shape
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)
    again = flash_attention.flash_attention_bwd_bhsd(q, k, v, o, do, lse,
                                                     **kw)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def test_cuda_flash_attention_grad_through_ops(cuda):
    """ops.flash_attention on (B, S, H, D) tensors that require grad:
    the forward and backward kernels, once each, the forward kernel's L
    saved for the backward, and q, k, v get the plain version's
    gradients."""
    b, s, hq, hkv, d = 2, 190, 8, 4, 128
    rng = np.random.default_rng(6)
    q, k, v = (T(rng.normal(size=(b, s, h, d)).astype(np.float32),
                 cuda).bfloat16().requires_grad_() for h in (hq, hkv, hkv))
    do = T(rng.normal(size=(b, s, hq, d)).astype(np.float32),
           cuda).bfloat16()
    fa = flash_attention
    fa.flash_attention_bhsd.launches = 0
    fa.flash_attention_bwd_bhsd.launches = 0
    out = ops.flash_attention(q, k, v)
    # the backward is handed the forward kernel's L, saved beside O
    lse = out.grad_fn.next_functions[0][0].saved_tensors[4]
    _, want_lse = ref.flash_attention(
        q.transpose(1, 2).reshape(b * hq, s, d),
        k.transpose(1, 2).reshape(b * hkv, s, d),
        v.transpose(1, 2).reshape(b * hkv, s, d), g=2, return_lse=True)
    assert lse.shape == (b, hq, s) and lse.dtype == torch.float32
    torch.testing.assert_close(lse.reshape(b * hq, s), want_lse, atol=2e-3,
                               rtol=2e-3)
    got = torch.autograd.grad(out, (q, k, v), do)
    assert (fa.flash_attention_bhsd.launches,
            fa.flash_attention_bwd_bhsd.launches) == (1, 1)

    def plain(q, k, v):
        return ref.flash_attention(
            q.transpose(1, 2).reshape(b * hq, s, d),
            k.transpose(1, 2).reshape(b * hkv, s, d),
            v.transpose(1, 2).reshape(b * hkv, s, d), g=2) \
            .reshape(b, hq, s, d).transpose(1, 2)

    want = torch.autograd.grad(plain(q, k, v), (q, k, v), do)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert float(a.float().abs().max()) > 0
        torch.testing.assert_close(a.float(), w.float(), atol=2e-2,
                                   rtol=2e-2)


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
    (2, 20, 128, None, None),                     # one split per head
    (4, 700, 64, 100, 20.0),                      # window and softcap
    # head sizes off the tensor-core kernel (the smoke configs' 16)
    (2, 100, 16, None, None),
    (4, 257, 32, 50, None),
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_attention_many_heads(cuda, dtype):
    """More heads than the card holds CTAs (at most two splits a head,
    most heads one), and the fused combine's arrival counters reused
    across calls."""
    q, k, v = (T(x, cuda).to(dtype) for x in decode_case(400, 2, 300, 128,
                                                          seed=13))
    kv_len = T(np.random.default_rng(13).integers(0, 301, 400)
               .astype(np.int32), cuda)
    assert decode_attention.splits_for(400, 300, 32) == 2
    got = decode_attention.decode_attention_bhgd(q, k, v, kv_len)
    want = ref.decode_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    tol = CUDA_ATT_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert torch.equal(decode_attention.decode_attention_bhgd(q, k, v,
                                                              kv_len), got)


def test_cuda_decode_attention_refuses_misaligned(cuda):
    """16-byte cp.async copies: a cache whose slot stride is not a
    multiple of 8 bf16 elements raises; nothing falls back."""
    k = torch.zeros(2, 40, 132, dtype=torch.bfloat16, device=cuda)[..., :128]
    q = torch.zeros(2, 2, 128, dtype=torch.bfloat16, device=cuda)
    kv_len = torch.full((2,), 5, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        decode_attention.decode_attention_bhgd(q, k, k, kv_len)


@pytest.mark.parametrize("p,n,s,nc,full,resident,want", [
    # Q12's shape: the accumulator in shared memory, two CTAs an SM, one
    # wave of 248 CTAs of four tiles each
    (4, 10**6, 2000, 3, True, None, (62, 16384, True, 2)),
    # its sum/count input: eight small CTAs an SM, one tile each
    (4, 10**6, 2000, 1, False, None, (245, 4096, True, 8)),
    # S = 4500, C = 3: a 180 KB accumulator, one CTA an SM
    (4, 3001, 4500, 3, True, None, (1, 4096, True, 1)),
    # S = 9000, C = 4: 468 KB, kept in global memory; a chunk covers at
    # least as many rows as its accumulator has slots
    (2, 700, 9000, 4, True, None, (1, 4096, False, 8)),
    (1, 2 * 10**6, 9000, 4, True, None, (16, 126976, False, 8)),
    (3, 0, 16, 0, True, None, (1, 4096, True, 8)),
    # the card's own count of resident CTAs (registers included) caps the
    # wave: Q9's shape at three CTAs an SM instead of five
    (4, 10**6, 2000, 1, True, None, (123, 8192, True, 5)),
    (4, 10**6, 2000, 1, True, 3, (82, 12288, True, 3))])
def test_seg_aggregate_plan(p, n, s, nc, full, resident, want):
    """The launch plan from the shapes alone: chunks of whole 4096-row
    tiles covering N, about one resident wave of the 132 SMs, and the
    shared memory the kernel's layout asks for."""
    pl = seg_aggregate.plan_for(p, n, s, nc, full, sms=132,
                                resident=resident)
    assert (pl.chunks, pl.chunk_rows, pl.smem_acc, pl.ctas_per_sm) == want
    assert pl.chunk_rows % seg_aggregate.TILE_ROWS == 0
    assert (pl.chunks - 1) * pl.chunk_rows < max(n, 1) <= \
        pl.chunks * pl.chunk_rows
    assert pl.chunks * p <= 132 * pl.ctas_per_sm + p
    width = s * (1 + (3 if full else 1) * nc)
    row_bytes = 4 + 4 * nc + (nc if full else 0)
    assert pl.width == width and pl.scratch_floats == p * pl.chunks * width
    assert pl.smem_bytes == pl.list_cap * row_bytes \
        + (-(-4 * width // 16) * 16 if pl.smem_acc else 0)
    assert pl.smem_bytes <= 232448 - seg_aggregate._STATIC_SMEM


def test_seg_aggregate_plan_wide_columns():
    """Many value columns shrink the row list; too many raise."""
    pl = seg_aggregate.plan_for(2, 5000, 10, 64, True)
    assert not pl.smem_acc and 32 <= pl.list_cap < seg_aggregate.LIST_CAP
    with pytest.raises(ValueError, match="columns"):
        seg_aggregate.plan_for(2, 5000, 10, 20000, True)


def test_decode_tile_and_splits():
    """Tiles of 32 slots on the tensor cores (bf16, D = 64, 128, 256),
    else of 8 KB (8..64 slots); the grid allows a head up to twice its
    share of the card's ~396 resident CTAs, at most one per tile."""
    assert decode_attention.tile_slots(128, 2) == 32
    assert decode_attention.tile_slots(256, 2) == 32
    assert decode_attention.tile_slots(64, 2) == 32
    assert decode_attention.tile_slots(256, 4) == 8
    assert decode_attention.tile_slots(64, 4) == 32
    assert decode_attention.tile_slots(16, 2) == 64
    assert decode_attention.splits_for(64, 2080, 32) == 13
    assert decode_attention.splits_for(6, 2080, 32) == 65
    assert decode_attention.splits_for(400, 300, 32) == 2
    assert decode_attention.splits_for(6, 20, 32) == 1


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


SUM_COUNT_EDGES = [
    # kind, P, N, S (as AGG_EDGES)
    ("runs", 4, 100003, 2000), ("hot", 2, 50000, 64),
    ("sparse", 4, 200000, 2000), ("runs", 2, 9000, 1), ("runs", 3, 33, 5),
    ("none", 3, 5000, 37)]


@pytest.mark.parametrize("p,n,s,valid_share,kind", [
    pytest.param(4, 5000, 37, 0.8, "random", id="4-5000-37-0.8"),
    pytest.param(2, 3001, 9000, 0.8, "random", id="2-3001-9000-0.8"),
    pytest.param(3, 999, 4096, 0.0, "random", id="3-999-4096-0.0"),
    pytest.param(4, 300000, 2000, 0.8, "random", id="4-300000-2000-0.8"),
    *[pytest.param(p, n, s, 0.0, k, id=f"{k}-{p}-{n}-{s}")
      for k, p, n, s in SUM_COUNT_EDGES]])
def test_cuda_segmented_sum_count(cuda, p, n, s, valid_share, kind):
    rng = np.random.default_rng(n + s)
    vals = (rng.integers(-400, 400, (p, n)) / 10.0).astype(np.float32)
    if kind == "random":
        segs = rng.integers(-3, s + 3, (p, n)).astype(np.int32)
        valid = rng.random((p, n)) < valid_share
    else:
        segs, valid = seg_layout(rng, p, n, s, kind)
    args = (T(vals, cuda), T(segs, cuda), T(valid, cuda), s)
    sums, counts = seg_aggregate.segmented_sum_count(*args)
    wsums, wcounts = ref.segmented_sum_count(*args)
    mag, _ = ref.segmented_sum_count(args[0].abs(), *args[1:])
    torch.cuda.synchronize()
    assert torch.equal(counts, wcounts)
    assert bool(((sums - wsums).abs() <= SUM_RTOL * mag + 1e-30).all())
    again, _ = seg_aggregate.segmented_sum_count(*args)
    assert torch.equal(again, sums)
