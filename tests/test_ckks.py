"""CKKS evaluator tests (mirrors the reference's cheap-crypto fixture tier,
SURVEY.md §4.1: small ring, no security claim)."""

import numpy as np
import pytest

from sorting_fhe_tpu.core.ckks import CkksContext, CkksConfig

RNG = np.random.default_rng(7)


@pytest.fixture(scope="module")
def ctx():
    return CkksContext(CkksConfig(ring_dim=1 << 10, mult_depth=6,
                                  scale_bits=52, comp=2, dnum=3))


@pytest.fixture(scope="module")
def ctx_rot(ctx):
    ctx.gen_rotation_keys([1, 2, 3, 8])
    return ctx


def test_encrypt_decrypt(ctx):
    v = RNG.uniform(-1, 1, ctx.params.num_slots)
    assert np.abs(ctx.decrypt(ctx.encrypt(v)) - v).max() < 1e-9


def test_add_sub_scalar(ctx):
    s = ctx.params.num_slots
    v, w = RNG.uniform(-1, 1, s), RNG.uniform(-1, 1, s)
    a, b = ctx.encrypt(v), ctx.encrypt(w)
    assert np.abs(ctx.decrypt(ctx.add(a, b)) - (v + w)).max() < 1e-9
    assert np.abs(ctx.decrypt(ctx.sub(a, b)) - (v - w)).max() < 1e-9
    assert np.abs(ctx.decrypt(ctx.add(a, 0.25)) - (v + 0.25)).max() < 1e-9
    assert np.abs(ctx.decrypt(ctx.rsub(1.0, a)) - (1.0 - v)).max() < 1e-9
    assert np.abs(ctx.decrypt(ctx.mult_scalar(a, -0.5)) - v * -0.5).max() < 1e-9


def test_mult_ct_and_pt(ctx):
    s = ctx.params.num_slots
    v, w = RNG.uniform(-1, 1, s), RNG.uniform(-1, 1, s)
    a, b = ctx.encrypt(v), ctx.encrypt(w)
    m = ctx.mult(a, b)
    assert m.noise_deg == 2
    assert np.abs(ctx.decrypt(m) - v * w).max() < 1e-9
    pt = ctx.make_plaintext(w, a.limbs, ctx.delta, s)
    assert np.abs(ctx.decrypt(ctx.mult(a, pt)) - v * w).max() < 1e-9
    assert np.abs(ctx.decrypt(ctx.square(a)) - v * v).max() < 1e-9


def test_depth_chain(ctx):
    s = ctx.params.num_slots
    x = ctx.encrypt(np.full(s, 0.95))
    val = np.full(s, 0.95)
    for _ in range(ctx.cfg.mult_depth - 1):
        x = ctx.square(x)
        val = val * val
    assert np.abs(ctx.decrypt(x) - val).max() < 1e-8
    # level accounting: fresh nq limbs, one level = comp limbs per mult
    consumed = ctx.params.nq - x.limbs
    assert consumed == (ctx.cfg.mult_depth - 2) * ctx.params.comp


def test_mixed_level_add(ctx):
    """Adds across different levels exercise the adjust machinery."""
    s = ctx.params.num_slots
    v, w = RNG.uniform(-1, 1, s), RNG.uniform(-1, 1, s)
    a, b = ctx.encrypt(v), ctx.encrypt(w)
    deep = ctx.mult(ctx.mult(a, b), a)        # depth 2
    mix = ctx.add(deep, b)                    # fresh + deep
    assert np.abs(ctx.decrypt(mix) - (v * v * w + w)).max() < 1e-8
    mix2 = ctx.add(b, deep)
    assert np.abs(ctx.decrypt(mix2) - (v * v * w + w)).max() < 1e-8


def test_rotations(ctx_rot):
    ctx = ctx_rot
    s = ctx.params.num_slots
    v = RNG.uniform(-1, 1, s)
    a = ctx.encrypt(v)
    for k in [1, 2, 3, 8]:
        got = ctx.decrypt(ctx.rotate(a, k))
        assert np.abs(got - np.roll(v, -k)).max() < 1e-8, k


def test_hoisted_rotations(ctx_rot):
    ctx = ctx_rot
    s = ctx.params.num_slots
    v = RNG.uniform(-1, 1, s)
    a = ctx.encrypt(v)
    pre = ctx.fast_rotation_precompute(a)
    for k in [1, 3, 8]:
        got = ctx.decrypt(ctx.fast_rotation(a, k, pre))
        assert np.abs(got - np.roll(v, -k)).max() < 1e-8, k


def test_rotation_after_mult(ctx_rot):
    ctx = ctx_rot
    s = ctx.params.num_slots
    v, w = RNG.uniform(-1, 1, s), RNG.uniform(-1, 1, s)
    m = ctx.mult(ctx.encrypt(v), ctx.encrypt(w))
    got = ctx.decrypt(ctx.rotate(m, 2))
    assert np.abs(got - np.roll(v * w, -2)).max() < 1e-8


def test_slots_replication(ctx):
    v4 = RNG.uniform(-1, 1, 4)
    ct = ctx.encrypt(v4, slots=4)
    assert np.abs(ctx.decrypt(ct) - v4).max() < 1e-9
    full = ctx.decrypt(ct.with_slots(ctx.params.num_slots))
    assert np.abs(full.reshape(-1, 4) - v4).max() < 1e-9


def test_zero_ciphertext(ctx):
    z = ctx.fresh_zero()
    assert np.abs(ctx.decrypt(z)).max() == 0.0
    v = RNG.uniform(-1, 1, ctx.params.num_slots)
    a = ctx.encrypt(v)
    assert np.abs(ctx.decrypt(ctx.add(z, a)) - v).max() < 1e-9


def test_match_add_comp1_fixpoint():
    """Regression (found by test_sharded_full_sort): at comp=1 the PS
    Chebyshev recursion produces adds whose operands arrive one limb apart
    with matching scales; _match_add must equalize BOTH limbs and scale
    (ckks.py _match_add fixpoint).  Runs the exact failing path — the
    doubled-sinc series the DirectSort N=4 permutation stage evaluates —
    on a plain (unsharded) comp=1 context."""
    from sorting_fhe_tpu.core.poly_eval import eval_chebyshev_series_ps
    from sorting_fhe_tpu.ops.chebyshev import doubled_sinc_coefficients

    ctx = CkksContext(CkksConfig(ring_dim=1 << 8, mult_depth=12,
                                 scale_bits=26, comp=1, dnum=4))
    c = doubled_sinc_coefficients(4)
    s = ctx.params.num_slots
    v = RNG.uniform(-1, 1, s)
    out = eval_chebyshev_series_ps(ctx, ctx.encrypt(v), c)
    got = ctx.decrypt(out)
    want = np.polynomial.chebyshev.chebval(v, c)
    assert np.abs(got - want).max() < 1e-3
    # scale stays near canonical (within the evaluator's drift tolerance;
    # comp=1 primes only approximate 2^scale_bits).  The evaluator is
    # lazy about the final rescale, so normalize to deg-1 first.
    out = ctx.rescale(out) if out.noise_deg == 2 else out
    assert abs(out.scale / ctx.params.canonical_scale[out.limbs] - 1) < 0.01
