"""Sign / comparison evaluator tests.

Mirrors the reference's SignTest (tests/SignTest.cpp, ring 2^12 cheap
config) and CompareTest (tests/CompareTest.cpp): sign accuracy at a margin,
compare producing {0,1}, indicator windows.  Scaled down to ring 2^10 for
CI speed; bench.py runs full-fidelity parameters on the GPU.
"""

import numpy as np
import pytest

from sorting_fhe_tpu.core.ckks import CkksContext, CkksConfig
from sorting_fhe_tpu.core.poly_eval import (
    eval_chebyshev_series_ps, chebyshev_coefficients, eval_poly_linear)
from sorting_fhe_tpu.ops.sign import (
    SignFunc, SignConfig, CompositeSignConfig, sign)
from sorting_fhe_tpu.ops.comparison import compare, indicator, Sinc

RNG = np.random.default_rng(3)


@pytest.fixture(scope="module")
def ctx():
    return CkksContext(CkksConfig(ring_dim=1 << 10, mult_depth=16,
                                  scale_bits=52, comp=2, dnum=4))


def _margin_vec(slots, margin):
    v = RNG.uniform(-1, 1, slots)
    return np.where(np.abs(v) < margin, margin * np.sign(v + 1e-12), v)


def test_chebyshev_ps(ctx):
    s = ctx.params.num_slots
    v = RNG.uniform(-1, 1, s)
    ct = ctx.encrypt(v)
    cf = chebyshev_coefficients(np.sin, -1, 1, 27)
    out = eval_chebyshev_series_ps(ctx, ct, cf)
    assert np.abs(ctx.decrypt(out) - np.sin(v)).max() < 1e-7


def test_chebyshev_ps_range_map(ctx):
    s = ctx.params.num_slots
    v = RNG.uniform(0, 2, s)
    ct = ctx.encrypt(v)
    cf = chebyshev_coefficients(np.cos, 0, 2, 20)
    out = eval_chebyshev_series_ps(ctx, ct, cf, 0.0, 2.0)
    assert np.abs(ctx.decrypt(out) - np.cos(v)).max() < 1e-7


def test_poly_linear(ctx):
    s = ctx.params.num_slots
    v = RNG.uniform(-1, 1, s)
    ct = ctx.encrypt(v)
    out = eval_poly_linear(ctx, ct, [0.5, -0.25, 0.0, 1.0, 0.0, 2.0])
    want = 0.5 - 0.25 * v + v ** 3 + 2.0 * v ** 5
    assert np.abs(ctx.decrypt(out) - want).max() < 1e-8


def test_composite_sign3(ctx):
    s = ctx.params.num_slots
    v = _margin_vec(s, 1.0 / 16)
    ct = ctx.encrypt(v)
    cfg = SignConfig(CompositeSignConfig(3, 2, 2))
    out = sign(ctx, ct, SignFunc.CompositeSign, cfg)
    assert np.abs(ctx.decrypt(out) - np.sign(v)).max() < 1e-3


def test_signum_polycircuit(ctx):
    """Degree-1023 Chebyshev sign (reference sign.cpp:189-608)."""
    s = ctx.params.num_slots
    v = _margin_vec(s, 1.0 / 16)
    ct = ctx.encrypt(v)
    out = sign(ctx, ct, SignFunc.SignumPolycircuit,
               SignConfig(CompositeSignConfig()))
    err = np.abs(ctx.decrypt(out) - np.sign(v)).max()
    assert err < 0.05, err


def test_signum_polycircuit_coefficient_parity():
    """The exact table IS the reference's constant vector: spot-check the
    values transcribed from sign.cpp:191-445 (main series) and the
    hand-unrolled tails T1009..T1023 (sign.cpp:469-571), and confirm the
    regenerated fit agrees to ~1e-4 everywhere."""
    from sorting_fhe_tpu.ops.sign import signum_polycircuit_coefficients
    exact = signum_polycircuit_coefficients(exact=True)
    assert len(exact) == 1024
    assert exact[1] == 1.273238551875655            # sign.cpp:192
    assert exact[3] == -0.42441020299615195
    assert exact[1009] == 5.3627954846304366e-05    # sign.cpp:470 (T1009)
    assert exact[1021] == 1.7871969994745013e-05    # sign.cpp:535 (T1021)
    assert exact[1023] == -1.1914460923282231e-05   # sign.cpp:571 (T1023)
    assert np.all(exact[0::2] == 0.0)               # odd function
    # the reference's constants follow the ANALYTIC Chebyshev series of
    # sign (c1 = 4/pi); our regenerated fit interpolates at 1024 nodes, so
    # the tail aliases — informational agreement profile only (the exact
    # table is the default)
    assert abs(exact[1] - 4.0 / np.pi) < 1e-6
    regen = signum_polycircuit_coefficients(exact=False)
    assert np.abs(exact - regen)[:100].max() < 2e-4
    assert np.abs(exact - regen).max() < 2e-3


def test_compare(ctx):
    s = ctx.params.num_slots
    a = RNG.uniform(0, 1, s)
    d = _margin_vec(s, 1.0 / 16)
    b = a - d
    cfg = SignConfig(CompositeSignConfig(3, 2, 2))
    out = compare(ctx, ctx.encrypt(a), ctx.encrypt(b),
                  SignFunc.CompositeSign, cfg)
    want = (d > 0).astype(float)
    assert np.abs(ctx.decrypt(out) - want).max() < 1e-3


def test_indicator(ctx):
    s = ctx.params.num_slots
    # values away from the +-c boundary by a margin; x +- c must stay inside
    # [-1, 1] (the composite sign's domain, as in the reference's usage on
    # 1/N-scaled ranks)
    v = RNG.uniform(-0.7, 0.7, s)
    c = 0.25
    v = np.where(np.abs(np.abs(v) - c) < 0.07,
                 np.sign(v) * (c + 0.1), v)
    cfg = SignConfig(CompositeSignConfig(3, 2, 2))
    out = indicator(ctx, ctx.encrypt(v), c, SignFunc.CompositeSign, cfg)
    want = (np.abs(v) < c).astype(float)
    assert np.abs(ctx.decrypt(out) - want).max() < 1e-2


def test_sinc_kernels():
    """Plain-math Sinc family (reference comparison.h:11-79, SincTest)."""
    s = Sinc(16)
    assert s.scaled_sinc(0.0) == 1.0
    # zeros at multiples of 1/N
    for k in [1, 2, 5]:
        assert abs(s.scaled_sinc(k / 16.0)) < 1e-12
    # doubled sinc: 1 at 0 and at -0.5
    assert abs(s.doubled_sinc(0.0) - 1.0) < 1e-9
    assert abs(s.doubled_sinc(-0.5) - 1.0) < 1e-9
    for k in [1, 2, 3]:
        assert abs(s.doubled_sinc(k / 16.0)) < 1e-9


def test_sinc_chebyshev_fit_quality():
    """Mirror of SincTest's fit-quality check (tests/SincTest.cpp:42-170):
    L-inf of the Chebyshev fit of scaled_sinc on the grid of multiples of
    1/(2N) must be small."""
    N = 16
    s = Sinc(2 * N)
    cf = chebyshev_coefficients(lambda t: s.scaled_sinc(t), -1, 1, 256)
    grid = np.arange(-2 * N, 2 * N) / (2.0 * N)
    got = np.polynomial.chebyshev.chebval(grid, cf)
    want = np.array([s.scaled_sinc(t) for t in grid])
    assert np.abs(got - want).max() < 1e-9
