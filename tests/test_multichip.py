"""Multi-chip (mesh-sharded) tests on the 8 virtual CPU devices.

The reference has no distributed tests (its only parallelism is OpenMP,
SURVEY.md §2.3); these cover the limb-parallel (TP) sharding
path: a full homomorphic step (mult + relinearize + rescale + rotate), a
sharded constructRank, and a sharded end-to-end sort, all under an
8-device jax.sharding.Mesh with the sharding asserted on the outputs.
"""

import numpy as np
import pytest
import jax
from jax.sharding import PartitionSpec as P

from sorting_fhe_tpu.core.ckks import CkksContext, CkksConfig, Ciphertext
from sorting_fhe_tpu.models.direct_sort import DirectSort
from sorting_fhe_tpu.ops.sign import SignConfig, CompositeSignConfig
from sorting_fhe_tpu.parallel.mesh import (
    make_mesh, limb_sharding, shard_ciphertext, shard_context_tables)
from sorting_fhe_tpu.utils.testvec import vector_with_min_diff

RNG = np.random.default_rng(7)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


@pytest.fixture(scope="module")
def sctx(mesh):
    """Limb-sharded context: nq = 2 + 14 = 16 and 8 special primes split
    evenly over 8 devices (the dryrun_multichip geometry)."""
    ctx = CkksContext(CkksConfig(ring_dim=1 << 8, mult_depth=14,
                                 scale_bits=26, comp=1, dnum=2))
    return shard_context_tables(ctx, mesh)


def test_sharded_homomorphic_step(sctx, mesh):
    """mult + relinearize + rescale + rotate under jit with limb-sharded
    inputs; output sharding is asserted, result decrypts correctly."""
    ctx = sctx
    ctx.gen_rotation_keys([1])
    N = 4
    v = vector_with_min_diff(N, 0, 1, 1.0 / N, RNG)
    w = vector_with_min_diff(N, 0, 1, 1.0 / N, RNG)
    a = shard_ciphertext(ctx.encrypt(v, slots=N), mesh)
    b = shard_ciphertext(ctx.encrypt(w, slots=N), mesh)
    ls = limb_sharding(mesh)

    def step(ad, bd):
        ca = Ciphertext(ad, ctx.delta, 1, N)
        cb = Ciphertext(bd, ctx.delta, 1, N)
        m = ctx.rescale(ctx.mult(ca, cb))
        return ctx.add(ctx.rotate(m, 1), m).data

    # note: the rescaled output has nq-1 limbs, which need not divide the
    # mesh; GSPMD picks the output sharding (inputs stay limb-sharded)
    out = jax.jit(step, in_shardings=(ls, ls))(a.data, b.data)
    out.block_until_ready()
    assert len(out.sharding.device_set) == 8
    got = ctx.decrypt(Ciphertext(
        out, ctx.params.canonical_scale[a.limbs - ctx.params.comp], 1, N))[:N]
    want = np.roll(v * w, -1) + v * w
    assert np.abs(got - want).max() < 1e-2


def test_sharded_construct_rank(sctx, mesh):
    """constructRank (baby-step rotations + SIMD compare + log-tree
    reduction) on a limb-sharded context."""
    ctx = sctx
    N = 4
    ds = DirectSort(ctx, N)
    v = vector_with_min_diff(N, 0, 1, 1.0 / N, RNG)
    ct = shard_ciphertext(ctx.encrypt(v, slots=N), mesh)
    cfg = SignConfig(CompositeSignConfig(3, 1, 1))
    rank_ct = ds.construct_rank(ct, cfg)
    assert len(rank_ct.data.sharding.device_set) == 8
    rank = ctx.decrypt(rank_ct)[:N]
    want = np.argsort(np.argsort(v))
    # one g/f iteration each: coarse sign, rank within half a unit
    assert np.abs(rank - want).max() < 0.5


def test_explicit_collective_keyswitch(sctx, mesh):
    """shard_map keyswitch with EXPLICIT all_gathers (SURVEY §5.8 b-c):
    matches the GSPMD evaluator's result and its lowered HLO contains
    exactly the designed collectives."""
    from sorting_fhe_tpu.parallel.collective import ShardedKeyswitch
    ctx = sctx
    N = 4
    v = vector_with_min_diff(N, 0, 1, 1.0 / N, RNG)
    w = vector_with_min_diff(N, 0, 1, 1.0 / N, RNG)
    a = shard_ciphertext(ctx.encrypt(v, slots=N), mesh)
    b = shard_ciphertext(ctx.encrypt(w, slots=N), mesh)

    sk = ShardedKeyswitch(ctx, mesh)
    out = sk.mult_relin(a, b)
    assert out.data.sharding.shard_shape(out.data.shape)[1] == \
        ctx.params.nq // 8, "limb axis must stay split"
    got = ctx.decrypt(ctx.rescale(out))[:N]
    # reference result through the GSPMD evaluator
    want = ctx.decrypt(ctx.rescale(ctx.mult(a, b)))[:N]
    assert np.abs(got - v * w).max() < 1e-2
    assert np.abs(got - want).max() < 1e-4

    # the comm pattern is explicit in the IR: two designed all-gathers
    # (digit xhat + moddown sp xhat), no compiler-inferred extras
    hlo = sk.lowered_hlo()
    n_gather = hlo.count("all_gather") + hlo.count("all-gather")
    assert n_gather >= 2, f"expected the 2 designed all-gathers:\n{n_gather}"
    bytes_ = sk.collective_bytes(k=2)
    # digit gather: (7/8) * 16 rows * 256 coeff * 4 B
    assert bytes_["digit_allgather_B"] == int(7 / 8 * 16 * 256 * 4)
    assert bytes_["moddown_allgather_B"] == int(7 / 8 * 2 * 8 * 256 * 4)


def test_explicit_collective_rotate_fused(sctx, mesh):
    """Explicit-collective fused rotation: matches the
    GSPMD evaluator, and the per-sort comm budget composes bytes x op
    census."""
    from sorting_fhe_tpu.parallel.collective import ShardedKeyswitch
    ctx = sctx
    ctx.gen_rotation_keys([1, 3])
    N = 4
    v = vector_with_min_diff(N, 0, 1, 1.0 / N, RNG)
    a = shard_ciphertext(ctx.encrypt(v, slots=N), mesh)
    sk = ShardedKeyswitch(ctx, mesh)
    for k in (1, 3):
        got = ctx.decrypt(sk.rotate(a, k))[:N]
        want = np.roll(v, -k)
        assert np.abs(got - want).max() < 1e-2, k
        ref = ctx.decrypt(ctx.rotate(a, k))[:N]
        assert np.abs(got - ref).max() < 1e-4, k
    # comm budget: every keyswitch consumer moves the two designed
    # gathers; hoisted fast-rotations share one digit gather
    census = {"mult_relin": 10, "rotate_fused": 5, "fast_rotate": 6,
              "decompose": 2, "square_relin": 0}
    bud = sk.comm_budget(census)
    b = sk.collective_bytes(k=2)
    assert bud["keyswitch_ops"] == 21
    assert bud["digit_gathers"] == 17
    assert bud["total_receive_B"] == (17 * b["digit_allgather_B"]
                                      + 21 * b["moddown_allgather_B"])


def test_explicit_collective_digit_boundary_spans_device():
    """Regression: a digit boundary INSIDE one device's row
    block.  nq=16, dnum=3 -> alpha=6 (digits [0:6],[6:12],[12:16]); on a
    4-device mesh each device owns 4 rows, so device 1 (rows 4..7) spans
    the boundary at 6.  The old global-index lookup into the local
    dig_of_row shard clamped out of range and mis-masked the exact-copy
    rows on every device but 0."""
    from sorting_fhe_tpu.parallel.collective import ShardedKeyswitch
    m4 = make_mesh(4)
    ctx = CkksContext(CkksConfig(ring_dim=1 << 8, mult_depth=14,
                                 scale_bits=26, comp=1, dnum=3,
                                 num_special_primes=8))
    shard_context_tables(ctx, m4)
    assert ctx.params.alpha % (ctx.params.nq // 4) != 0 or \
        (ctx.params.nq // 4) % ctx.params.alpha != 0, \
        "config must make a device span a digit boundary"
    N = 4
    v = vector_with_min_diff(N, 0, 1, 1.0 / N, RNG)
    w = vector_with_min_diff(N, 0, 1, 1.0 / N, RNG)
    a = shard_ciphertext(ctx.encrypt(v, slots=N), m4)
    b = shard_ciphertext(ctx.encrypt(w, slots=N), m4)
    sk = ShardedKeyswitch(ctx, m4)
    got = ctx.decrypt(ctx.rescale(sk.mult_relin(a, b)))[:N]
    want = ctx.decrypt(ctx.rescale(ctx.mult(a, b)))[:N]
    assert np.abs(got - v * w).max() < 1e-2
    assert np.abs(got - want).max() < 1e-4


def test_sharded_full_sort(mesh):
    """End-to-end encrypted DirectSort on the 8-device mesh."""
    ctx = CkksContext(CkksConfig(ring_dim=1 << 8, mult_depth=26,
                                 scale_bits=26, comp=1, dnum=4))
    shard_context_tables(ctx, mesh)
    N = 4
    ds = DirectSort(ctx, N)
    v = vector_with_min_diff(N, 0, 1, 1.0 / N, RNG)
    ct = shard_ciphertext(ctx.encrypt(v, slots=N), mesh)
    out_ct = ds.sort(ct)
    assert len(out_ct.data.sharding.device_set) == 8
    got = ctx.decrypt(out_ct)[:N]
    assert np.abs(got - np.sort(v)).max() < 0.02
