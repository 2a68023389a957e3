"""BitonicSort + MEHP24 tests (plaintext-mock structure tier + encrypted
component tier), mirroring BitonicSortTest and tests/mehp24/Mehp24SortTest.
"""

import numpy as np
import pytest

from sorting_fhe_tpu.utils.plain import PlainContext
from sorting_fhe_tpu.utils.testvec import vector_with_min_diff
from sorting_fhe_tpu.models.bitonic import BitonicSort
from sorting_fhe_tpu.models import mehp24 as M
from sorting_fhe_tpu.ops.sign import SignConfig, CompositeSignConfig

RNG = np.random.default_rng(5)


@pytest.mark.parametrize("N", [4, 8, 16, 64, 128])
def test_bitonic_plain(N):
    ctx = PlainContext(1 << 13)
    bs = BitonicSort(ctx, N)
    v = vector_with_min_diff(N, 0, 255, 255.0 / N, RNG)
    got = ctx.decrypt(bs.sort(ctx.encrypt(v, slots=N),
                              SignConfig(CompositeSignConfig(3, 3, 2))))
    assert np.abs(got - np.sort(v)).max() < 0.01


@pytest.mark.parametrize("N", [4, 8, 16, 32])
def test_mehp24_sortfg_plain(N):
    ctx = PlainContext(1 << 12)
    v = vector_with_min_diff(N, 0, 1, 1.0 / N, RNG)
    dg = 2 if N <= 8 else 3
    out = M.sort_fg(ctx, ctx.encrypt(v, slots=N * N), N, dg, 2, dg, 2)
    got = ctx.decrypt(out)[:N]
    assert np.abs(got - np.sort(v)).max() < 0.01


def test_mehp24_sortfg_signfunc_default_cfg():
    """The SignFunc overload with sign_cfg omitted must default-construct
    (reference SignConfig() default-constructs, sign.h:25) — regression for
    a TypeError when it was left as None (mehp24.py:237)."""
    from sorting_fhe_tpu.ops.sign import SignFunc
    ctx = PlainContext(1 << 12)
    N = 4
    v = vector_with_min_diff(N, 0, 1, 1.0 / N, RNG)
    out = M.sort_fg(ctx, ctx.encrypt(v, slots=N * N), N, 2, 2, 2, 2,
                    sign_func=SignFunc.CompositeSign)
    got = ctx.decrypt(out)[:N]
    assert np.abs(got - np.sort(v)).max() < 0.01


def test_mehp24_multi_and_large_plain():
    ctx = PlainContext(1 << 12)
    v = vector_with_min_diff(32, 0, 1, 1.0 / 32, RNG)
    parts = [ctx.encrypt(v[i * 8:(i + 1) * 8], slots=64) for i in range(4)]
    outs = M.sort_fg_multi(ctx, parts, 8, 3, 2, 3, 2)
    got = np.concatenate([ctx.decrypt(o)[:8] for o in outs])
    assert np.abs(got - np.sort(v)).max() < 0.01

    ct = ctx.encrypt(v, slots=64)
    out = M.sort_large_array_fg(ctx, ct, 32, 8, 3, 2, 3, 2)
    got = ctx.decrypt(out)[:32]
    assert np.abs(got - np.sort(v)).max() < 0.01


def test_mehp24_matrix_ops_plain():
    """Matrix primitive semantics (mirrors the reference's utils tests)."""
    ctx = PlainContext(1 << 10)
    n = 4
    m = M.Mehp24(ctx, n)
    v = np.arange(1.0, 5.0)
    row0 = ctx.encrypt(v, slots=n * n)           # vector in row 0
    VR = ctx.decrypt(m.replicate_row(row0)).reshape(n, n)
    assert np.allclose(VR, np.tile(v, (n, 1)))
    VC = ctx.decrypt(m.replicate_column(m.transpose_row(row0, True))
                     ).reshape(n, n)
    assert np.allclose(VC, np.tile(v[:, None], (1, n)))
    S = ctx.decrypt(m.sum_rows(m.replicate_row(row0))).reshape(n, n)
    assert np.allclose(S, np.tile(v * n, (n, 1)))
    SC = ctx.decrypt(m.sum_columns(VRct := m.replicate_row(row0), True)
                     ).reshape(n, n)
    assert np.allclose(SC[:, 0], v.sum())


def test_mehp24_depth2degree():
    assert M.depth2degree(5) == 13
    assert M.depth2degree(10) == 495
    assert M.depth2degree(99) == -1


def test_mehp24_rotation_indices():
    idx = M.rotation_indices(256)
    assert 1 in idx and -1 in idx and 128 in idx
    big = M.rotation_indices(512)
    assert 256 in big and -256 in big


# ---------------- encrypted tier (small params) ----------------

import os

SLOW = os.environ.get("SORTING_FHE_RUN_SLOW") != "1"


def test_mehp24_matrix_ops_encrypted():
    """Rotation-ladder matrix primitives under encryption (cheap: no
    multiplicative depth beyond the masks)."""
    from sorting_fhe_tpu.core.ckks import CkksContext, CkksConfig
    ctx = CkksContext(CkksConfig(ring_dim=1 << 10, mult_depth=4,
                                 scale_bits=52, comp=2, dnum=3))
    n = 4
    m = M.Mehp24(ctx, n)
    v = np.arange(1.0, 5.0) / 8.0
    row0 = ctx.encrypt(v, slots=n * n)
    VR = ctx.decrypt(m.replicate_row(row0)).reshape(n, n)
    assert np.abs(VR - np.tile(v, (n, 1))).max() < 1e-8
    VC = ctx.decrypt(m.replicate_column(m.transpose_row(row0, True))
                     ).reshape(n, n)
    assert np.abs(VC - np.tile(v[:, None], (1, n))).max() < 1e-8
    S = ctx.decrypt(m.sum_columns(m.replicate_row(row0), True)).reshape(n, n)
    assert np.abs(S[:, 0] - v.sum()).max() < 1e-8


@pytest.mark.skipif(SLOW, reason="full encrypted mehp24 sortFG needs ~30 "
                    "levels; set SORTING_FHE_RUN_SLOW=1 (bench covers the GPU)")
def test_mehp24_sortfg_encrypted():
    from sorting_fhe_tpu.core.ckks import CkksContext, CkksConfig
    ctx = CkksContext(CkksConfig(ring_dim=1 << 10, mult_depth=32,
                                 scale_bits=52, comp=2, dnum=6))
    N = 4
    v = vector_with_min_diff(N, 0, 1, 1.0 / N, RNG)
    out = M.sort_fg(ctx, ctx.encrypt(v, slots=N * N), N, 2, 2, 2, 2)
    got = ctx.decrypt(out)[:N]
    assert np.abs(got - np.sort(v)).max() < 0.01
