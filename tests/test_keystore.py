"""Rotation-key streaming: byte-capped LRU + deterministic device regen.

The reference never needs this — OpenFHE keeps every Galois key in 35-85
GB of host RAM (comparison/experimental_results peak-memory rows).  Under
a device-memory budget the KeyStore regenerates evicted keys on demand (core/keystore.py); these tests pin
the two properties that make that transparent: (a) regeneration is
bit-deterministic per rotation index, (b) sorts under a tiny budget
decrypt identically to resident-key sorts.
"""

import numpy as np
import pytest

from sorting_fhe_tpu.core.ckks import CkksContext, CkksConfig
from sorting_fhe_tpu.core.keystore import KeyStore
from sorting_fhe_tpu.utils.testvec import vector_with_min_diff

RNG = np.random.default_rng(11)


def test_keystore_mapping_semantics():
    calls = []

    def regen(k):
        calls.append(k)
        return np.zeros(4, dtype=np.uint32)  # nbytes = 16

    ks = KeyStore(budget_bytes=40, regen=regen)
    for k in (1, 2, 3, 4):
        ks.register(k)
    assert len(ks) == 4 and 3 in ks and 9 not in ks
    _ = ks[1], ks[2]
    assert calls == [1, 2]
    _ = ks[3]                       # 48 bytes resident -> evicts key 1
    assert ks.resident_bytes <= 40
    _ = ks[1]                       # miss -> regen again
    assert calls == [1, 2, 3, 1]
    _ = ks[3]                       # still resident -> no regen
    assert calls == [1, 2, 3, 1]
    ks[7] = np.zeros(64, dtype=np.uint32)   # pinned, never evicted
    _ = ks[4], ks[2], ks[1]
    assert np.asarray(ks[7]).nbytes == 256
    assert sorted(ks) == [1, 2, 3, 4, 7]
    ks.clear()
    assert len(ks) == 0


@pytest.fixture(scope="module")
def sctx():
    return CkksContext(CkksConfig(ring_dim=1 << 8, mult_depth=6,
                                  scale_bits=26, comp=1, dnum=2,
                                  rot_key_budget_mb=1))


def test_regen_deterministic(sctx):
    ctx = sctx
    ctx.gen_rotation_keys([1, 2, 3])
    k1 = np.asarray(ctx.rot_keys[1])
    n0 = ctx.rot_keys.regen_count
    ctx.rot_keys.evict(1)
    k1b = np.asarray(ctx.rot_keys[1])
    assert ctx.rot_keys.regen_count == n0 + 1   # eviction forced a regen
    assert np.array_equal(k1, k1b), "regenerated key must be bit-identical"


def test_streamed_rotation_matches_resident():
    N = 8
    v = vector_with_min_diff(N, 0, 1, 1.0 / N, RNG)
    cfgs = [CkksConfig(ring_dim=1 << 8, mult_depth=6, scale_bits=26,
                       comp=1, dnum=2, seed=77, rot_key_budget_mb=b)
            for b in (None, 1)]
    outs = []
    for cfg in cfgs:
        ctx = CkksContext(cfg)
        ctx.gen_rotation_keys([1, 2, 5])
        ct = ctx.encrypt(v, slots=N)
        r = ctx.rotate(ctx.rotate(ctx.rotate(ct, 1), 2), 5)
        outs.append(ctx.decrypt(r)[:N])
    want = np.roll(v, -8)
    assert np.abs(outs[0] - want).max() < 1e-3
    # budgeted context agrees with resident context to encryption noise
    assert np.abs(outs[0] - outs[1]).max() < 1e-3


@pytest.mark.heavy
def test_mehp24_sort_under_budget():
    """End-to-end mehp24 sortFG with a budget that forces eviction."""
    from sorting_fhe_tpu.models.mehp24 import sort_fg
    ctx = CkksContext(CkksConfig(ring_dim=1 << 10, mult_depth=34,
                                 scale_bits=52, comp=2, dnum=4,
                                 rot_key_budget_mb=2))
    v = np.array([0.8, 0.3, 0.55, 0.05])
    ct = ctx.encrypt(v, slots=16)
    out = sort_fg(ctx, ct, 4, 2, 2, 1, 2)
    got = ctx.decrypt(out)[:4]
    assert np.abs(got - np.sort(v)).max() < 0.01
    assert ctx.rot_keys.regen_count > len(ctx.rot_keys), \
        "budget must actually force re-generation"
