"""Hybrid direct-sort tests (rank from DirectSort + MEHP24-style
permutation; reference sort_algo.h:776-1389, tests/DirectSortH*Test.cpp).

Tiers: plaintext-mock for the algorithm logic at several N incl. the
multi-block N>256 path; encrypted N=4 end-to-end gated behind
SORTING_FHE_RUN_SLOW (chip_smoke.py runs full fidelity on the GPU).
"""

import os

import numpy as np
import pytest

from sorting_fhe_tpu.models.direct_sort import DirectSort
from sorting_fhe_tpu.ops.sign import SignConfig, CompositeSignConfig
from sorting_fhe_tpu.utils.plain import PlainContext
from sorting_fhe_tpu.utils.testvec import vector_with_min_diff

SLOW = os.environ.get("SORTING_FHE_RUN_SLOW") != "1"
RNG = np.random.default_rng(123)


def _plain_sort(N, ring, variant, sign_cfg=None):
    ctx = PlainContext(ring)
    vals = vector_with_min_diff(N, 0, 1, 1.0 / N, RNG)
    ct = ctx.encrypt(vals, slots=N)
    ds = DirectSort(ctx, N)
    cfg = sign_cfg or SignConfig(CompositeSignConfig(3, 8, 3))
    out = getattr(ds, variant)(ct, cfg)
    got = ctx.decrypt(out)[:N]
    return got, np.sort(vals)


@pytest.mark.parametrize("variant", ["sort_hybrid", "sort_hybrid1",
                                     "sort_hybrid2"])
@pytest.mark.parametrize("N,ring", [(4, 1 << 10), (16, 1 << 12)])
def test_hybrid_plain(N, ring, variant):
    got, want = _plain_sort(N, ring, variant)
    assert np.abs(got - want).max() < 1e-2, (got, want)


def test_hybrid1_plain_large_multiblock():
    """N=512 exercises the N>256 two-block path (sort_algo.h:1076-1082)."""
    got, want = _plain_sort(512, 1 << 17, "sort_hybrid1")
    assert np.abs(got - want).max() < 1e-2


@pytest.mark.parametrize("variant,N,ring", [
    ("sort", 16, 1 << 12),
    ("sort_hybrid1", 16, 1 << 12),
    ("sort_hybrid1", 128, 1 << 17),   # the bench's minimal-key geometry
    ("sort_hybrid2", 8, 1 << 10),
])
def test_minimal_keys_plain(variant, N, ring):
    """use_minimal_keys: every rotation composes from the pow-2 ladder.
    PlainContext rotations are exact, so any decomposition error (wrong
    wrap, missing bit) shows up as a mis-sorted vector."""
    ctx = PlainContext(ring)
    vals = vector_with_min_diff(N, 0, 1, 1.0 / N, RNG)
    ct = ctx.encrypt(vals, slots=N)
    ds = DirectSort(ctx, N, use_minimal_keys=True)
    from sorting_fhe_tpu.models.direct_sort import minimal_rotations
    assert set(ds.rot_indices) == set(minimal_rotations(N, ring // 2))
    out = getattr(ds, variant)(ct, SignConfig(CompositeSignConfig(3, 8, 3)))
    got = ctx.decrypt(out)[:N]
    assert np.abs(got - np.sort(vals)).max() < 1e-2


def test_sum_columns_to_target_plain():
    """sumColumnsToTarget/transposeColumnTarget geometry on a known matrix
    (sort_algo.h:824-891)."""
    ctx = PlainContext(1 << 10)
    sz = 4
    mat = np.arange(sz * sz, dtype=np.float64)
    ct = ctx.encrypt(mat, slots=sz * sz)
    ds = DirectSort(ctx, sz)
    for col in range(sz):
        s = ds.sum_columns_to_target(ct, sz, col, True)
        got = ctx.decrypt(s)[: sz * sz].reshape(sz, sz)
        want = np.zeros((sz, sz))
        want[:, col] = mat.reshape(sz, sz).sum(axis=1)
        assert np.allclose(got, want), (col, got)
    # column b moved to row b (the only pairing the algorithm uses:
    # sort_algo.h:988-991 passes the same b to both ladders)
    for b in range(sz):
        colv = np.zeros(sz * sz)
        colv[b::sz] = [10.0, 11.0, 12.0, 13.0]
        ctc = ctx.encrypt(colv, slots=sz * sz)
        t = ds.transpose_column_target(ctc, sz, b, True)
        got = ctx.decrypt(t)[: sz * sz].reshape(sz, sz)
        want = np.zeros((sz, sz))
        want[b] = [10.0, 11.0, 12.0, 13.0]
        assert np.allclose(got, want), (b, got)


@pytest.mark.skipif(SLOW, reason="encrypted hybrid1 N=4 needs ~34 levels; "
                    "set SORTING_FHE_RUN_SLOW=1 (bench covers the GPU)")
def test_hybrid1_encrypted_n4():
    from sorting_fhe_tpu.core.ckks import CkksContext
    from sorting_fhe_tpu.core.params import CkksConfig
    # depth 31 = the reference's own N=4 hybrid1 budget
    # (tests/DirectSortH1Test.cpp:40-113) — reachable since
    # eval_poly_linear folds coefficients into the power chains
    ctx = CkksContext(CkksConfig(ring_dim=1 << 10, mult_depth=31,
                                 scale_bits=52, comp=2, dnum=6))
    N = 4
    vals = vector_with_min_diff(N, 0, 1, 1.0 / N, RNG)
    ds = DirectSort(ctx, N)
    out = ds.sort_hybrid1(ctx.encrypt(vals, slots=N),
                          SignConfig(CompositeSignConfig(3, 2, 2)))
    got = np.asarray(ctx.decrypt(out))[:N]
    assert np.abs(got - np.sort(vals)).max() < 0.01, got
