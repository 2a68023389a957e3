"""Bootstrap at depth: the reference's real consumption regimes, un-gated.

Round-2 verdict item: exercise the REAL Bootstrapper (not recrypt_hook)
behind the two production triggers —

  * BitonicSort boots when consumed level > 29 on a depth-58 chain
    (/root/reference/src/sort_algo.h:1436-1438, BitonicSortTest.cpp:54)
  * k-way checkLevelAndBoot inside a k=2 M=4 (N=16) network at depth 40
    (/root/reference/src/k-way/EvalUtils.cpp:57-94, kway_adapter.h:41-64)

at ring 2^12 with sparse secrets, in the default suite (no slow gate).
"""

import numpy as np
import pytest

from sorting_fhe_tpu.core.params import CkksConfig
from sorting_fhe_tpu.core.ckks import CkksContext
from sorting_fhe_tpu.core.bootstrap import BootstrapHook
from sorting_fhe_tpu.ops.sign import SignConfig, CompositeSignConfig

pytestmark = pytest.mark.heavy  # encrypted deep-chain tier


def test_bitonic_real_bootstrap_ring12():
    """Exact fixture parity with the reference's BitonicSortTest: N=4,
    ring 2^12, MultDepth 58, sign (4,3,3), inputs in [0,255]
    (BitonicSortTest.cpp:20-72) — and its DUAL error gate: maxError < 1.0
    AND zero slots with error > 0.1 on the 0..255 scale
    (BitonicSortTest.cpp:88-103).  A 255*0.01=2.55 gate would be ~25x
    looser than the reference's effective 0.1 bound; the reference's gate for bitonic is NOT DirectSortTest's 0.01 — its
    own fixture asserts 1.0/0.1 on unnormalized values."""
    from sorting_fhe_tpu.models.bitonic import BitonicSort
    from sorting_fhe_tpu.utils.testvec import vector_with_min_diff

    cfg = CkksConfig(ring_dim=1 << 12, mult_depth=58, scale_bits=52, comp=2,
                     dnum=6, secret_hw=32)
    ctx = CkksContext(cfg)
    N = 4
    bs = BitonicSort(ctx, N, bootstrap_level=29,
                     bootstrap_hook=BootstrapHook(ctx))
    rng = np.random.default_rng(11)
    v = vector_with_min_diff(N, 0, 255, 0.01, rng)
    ct = ctx.encrypt(v, slots=N)
    out = bs.sort(ct, SignConfig(CompositeSignConfig(4, 3, 3),
                                 mult_depth=cfg.mult_depth))
    got = ctx.decrypt(out)[:N]
    err = np.abs(got - np.sort(v))
    assert err.max() < 1.0, err
    assert int((err > 0.1).sum()) == 0, err


def test_kway_k2_m4_real_bootstrap_ring11():
    """k=2 M=4 with REAL mid-network bootstraps.  Ring 2^11 rather than
    2^12 keeps the test to a few CPU-minutes: a quarter of the per-op
    cost, same stage geometry, same checkLevelAndBoot triggers."""
    from sorting_fhe_tpu.models.kway import KWaySorter
    from sorting_fhe_tpu.utils.testvec import vector_with_min_diff

    cfg = CkksConfig(ring_dim=1 << 11, mult_depth=40, scale_bits=52, comp=2,
                     dnum=6, secret_hw=32, limb_pad=8)
    ctx = CkksContext(cfg)
    N = 16
    sorter = KWaySorter(ctx, 2, 4, mult_depth=cfg.mult_depth,
                        bootstrap_hook=BootstrapHook(ctx))
    rng = np.random.default_rng(12)
    v = vector_with_min_diff(N, 0, 1, 1.0 / N, rng)
    ct = ctx.encrypt(v, slots=N)
    out = sorter.sort(ct, SignConfig(CompositeSignConfig(3, 2, 5),
                                     mult_depth=cfg.mult_depth))
    got = ctx.decrypt(out)[:N]
    assert np.abs(got - np.sort(v)).max() < 0.01
