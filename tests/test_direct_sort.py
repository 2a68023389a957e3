"""DirectSort tests, tiered like the reference suite (SURVEY.md §4):

1. Plaintext-mock tier (fast): full algorithm structure over numpy —
   equivalent of scripts/direct_sort_rank.py + the pure-logic tests.
2. Component tier with synthesized intermediate state (DirectSortNTest
   pattern, tests/DirectSortNTest.cpp:130-283): rotation-index-check fed a
   plaintext-computed rank, including the +-noise injection variant.
3. Full encrypted end-to-end (DirectSortTest pattern) — slow; gated behind
   SORTING_FHE_RUN_SLOW=1 (bench.py runs it at full size on the GPU).
"""

import os

import numpy as np
import pytest

from sorting_fhe_tpu.core.ckks import CkksContext, CkksConfig
from sorting_fhe_tpu.models.direct_sort import (
    DirectSort, default_sign_config, DIRECT_SORT_ROTATIONS)
from sorting_fhe_tpu.utils.plain import PlainContext
from sorting_fhe_tpu.utils.testvec import vector_with_min_diff
from sorting_fhe_tpu.ops.rotation import Decomposer, DecomposeAlgo

RNG = np.random.default_rng(11)


# ---------------- tier 1: plaintext mock ----------------

@pytest.mark.parametrize("N,ring", [(4, 1 << 10), (8, 1 << 11),
                                    (16, 1 << 12), (32, 1 << 12),
                                    (64, 1 << 13), (128, 1 << 14)])
def test_direct_sort_plain(N, ring):
    ctx = PlainContext(ring)
    ds = DirectSort(ctx, N)
    v = vector_with_min_diff(N, 0, 1, 1.0 / N, RNG)
    got = ctx.decrypt(ds.sort(ctx.encrypt(v, slots=N)))
    assert np.abs(got - np.sort(v)).max() < 0.01


@pytest.mark.parametrize("N,ring", [(4, 1 << 10), (16, 1 << 12),
                                    (64, 1 << 14)])
def test_direct_sort_2n_plain(N, ring):
    """sort via rotationIndexCheck2N (sort_algo.h:587-656)."""
    ctx = PlainContext(ring)
    ds = DirectSort(ctx, N)
    v = vector_with_min_diff(N, 0, 1, 1.0 / N, RNG)
    got = ctx.decrypt(ds.sort_2n(ctx.encrypt(v, slots=N)))
    assert np.abs(got - np.sort(v)).max() < 0.01


def test_direct_sort_plain_2048():
    """N=2048 plain-tier parity (reference DirectSortNTest.cpp:384-389 —
    the one size DirectSortTest itself skips) using the reference's
    irregular single-hop rotation set (sort_algo.h:166-196)."""
    ctx = PlainContext(1 << 17)
    ds = DirectSort(ctx, 2048)
    assert len(DIRECT_SORT_ROTATIONS[2048]) == 270
    v = vector_with_min_diff(2048, 0, 1, 1.0 / 2048, RNG)
    got = ctx.decrypt(ds.sort(ctx.encrypt(v, slots=2048)))
    assert np.abs(got - np.sort(v)).max() < 0.01


@pytest.mark.parametrize("N", [4, 16, 64])
def test_construct_rank_plain(N):
    ctx = PlainContext(1 << 13)
    ds = DirectSort(ctx, N)
    v = vector_with_min_diff(N, 0, 1, 1.0 / N, RNG)
    rank = ctx.decrypt(ds.construct_rank(
        ctx.encrypt(v, slots=N), default_sign_config(N)))[:N]
    want = np.argsort(np.argsort(v))
    assert np.abs(rank - want).max() < 1e-4  # reference rank gate (1e-4)


# ---------------- tier 2: decomposition logic (DecomposeTest) ----------------

@pytest.mark.parametrize("algo", [DecomposeAlgo.NAF, DecomposeAlgo.BNAF,
                                  DecomposeAlgo.BINARY])
def test_decomposer_roundtrip(algo):
    N = 128
    dec = Decomposer(DIRECT_SORT_ROTATIONS[N], N)
    for rot in range(1, 2 * N):
        steps = dec.decompose(rot, 1 << 30, algo)
        total = sum(s.step_size for s in steps)
        # NAF maps -N/2 to +N/2 (rotation.h:122-127), so equivalence is mod N
        assert total % N == rot % N, (algo, rot, steps)


def test_decomposer_wrap_elision():
    dec = Decomposer([1, 2, 4, 8, 16], 16)
    # steps that are multiples of the slot count are dropped
    steps = dec.decompose(16, 16, DecomposeAlgo.BINARY)
    assert steps == []


def test_rotation_stats_counters():
    """RotationStats fast/composed/total + tree cache hit/miss counters
    (reference rotation.h:168-191)."""
    from sorting_fhe_tpu.ops.rotation import RotationComposer, RotationTree
    from sorting_fhe_tpu.utils.plain import PlainContext

    ctx = PlainContext(1 << 10)
    v = np.arange(16, dtype=np.float64)
    ct = ctx.encrypt(v, slots=16)

    comp = RotationComposer(ctx, [1, 2, 4, 8], 512, DecomposeAlgo.BINARY)
    comp.rotate(ct, 2)                  # exact key -> fast path
    comp.rotate(ct, 7)                  # 4+2+1 -> 3 composed steps
    assert comp.stats.fast_rotations == 1
    assert comp.stats.normal_rotations == 3
    assert comp.stats.total_rotations == 4
    assert "total=4" in comp.stats.report()

    tree = RotationTree(ctx, [1, 2, 4, 8], 512, DecomposeAlgo.BINARY)
    tree.attach(ct)
    tree.rotate(12)                     # 8+4: two misses
    tree.rotate(14)                     # 8+4 prefix cached, +2: 2 hits 1 miss
    assert tree.stats.cache_misses == 3
    assert tree.stats.cache_hits == 2
    assert tree.stats.fast_rotations == 3
    comp.stats.reset()
    assert comp.stats.total_rotations == 0


# ---------------- tier 3: encrypted component / end-to-end ----------------

SLOW = os.environ.get("SORTING_FHE_RUN_SLOW") != "1"


@pytest.fixture(scope="module")
def ectx():
    return CkksContext(CkksConfig(ring_dim=1 << 10, mult_depth=15,
                                  scale_bits=52, comp=2, dnum=5))


def test_rotation_index_check_encrypted(ectx):
    """Permutation stage alone, fed a plaintext-computed rank — the
    synthesized-intermediate-state pattern of DirectSortNTest, including
    rank noise injection (tests/DirectSortNTest.cpp:205-283)."""
    N = 4
    ctx = ectx
    ds = DirectSort(ctx, N)
    v = vector_with_min_diff(N, 0, 1, 1.0 / N, RNG)
    rank = np.argsort(np.argsort(v)).astype(np.float64)
    noise = RNG.uniform(-1e-3, 1e-3, N)
    ct_in = ctx.encrypt(v, slots=N)
    ct_rank = ctx.encrypt(rank + noise, slots=N)
    out = ctx.decrypt(ds.rotation_index_check_n(ct_rank, ct_in))[:N]
    assert np.abs(out - np.sort(v)).max() < 0.01


def test_rotation_index_check_2n_encrypted(ectx):
    """2N permutation stage fed a synthesized rank (DirectSortNTest's
    RotationIndexCheck pattern applied to the 2N variant)."""
    N = 4
    ctx = ectx
    ds = DirectSort(ctx, N)
    v = vector_with_min_diff(N, 0, 1, 1.0 / N, RNG)
    rank = np.argsort(np.argsort(v)).astype(np.float64)
    ct_in = ctx.encrypt(v, slots=N)
    ct_rank = ctx.encrypt(rank, slots=N)
    out = ctx.decrypt(ds.rotation_index_check_2n(ct_rank, ct_in))[:N]
    assert np.abs(out - np.sort(v)).max() < 0.01


@pytest.mark.skipif(SLOW, reason="full encrypted sort is slow on CPU; "
                    "set SORTING_FHE_RUN_SLOW=1 (bench.py covers it on the GPU)")
def test_direct_sort_encrypted_n4():
    ctx = CkksContext(CkksConfig(ring_dim=1 << 10, mult_depth=30,
                                 scale_bits=52, comp=2, dnum=6))
    N = 4
    ds = DirectSort(ctx, N)
    v = vector_with_min_diff(N, 0, 1, 1.0 / N, RNG)
    got = ctx.decrypt(ds.sort(ctx.encrypt(v, slots=N)))[:N]
    assert np.abs(got - np.sort(v)).max() < 0.01


def test_pt_block_rotation_semantics(ectx):
    """_pt_block (base encode + device Galois permutation) must decode to
    the rolled mask.  Not bit-identical to a fresh encode — the float
    iFFT of the rolled vector rounds a few coefficients one ulp apart —
    but slot-exact, which is what the mask-mult consumes."""
    import numpy as np
    from sorting_fhe_tpu.models.direct_sort import _rotate_list
    ctx = ectx
    ds = DirectSort(ctx, 4)
    one = ctx.encrypt(np.ones(16), slots=16)
    num_slots = 16
    for k, s in [(0, 0), (1, 0), (2, -3), (3, 5), (1, 7)]:
        want_vec = _rotate_list(ds._mask(num_slots, k, 4), s)
        got = ds._pt_block(one, num_slots, 4, k, s)
        dec = ctx.decrypt(ctx.rescale(ctx.mult(one, got)))[:num_slots]
        assert np.abs(dec - want_vec).max() < 1e-6, (k, s, dec)
        assert got.slots == num_slots
