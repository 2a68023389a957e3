"""NTT + modular arithmetic unit tests (pure-logic tier, no crypto).

Mirrors the reference's DecomposeTest-style logic tests (SURVEY.md §4.5) and
validates the Phase-0 numerics scaffolding: NTT round trip, negacyclic
convolution vs an O(n^2) oracle, and the uint32 Montgomery/Shoup kernels.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from sorting_fhe_tpu.core import nt
from sorting_fhe_tpu.core.rns import (
    add_mod, sub_mod, mont_mul, shoup_mul, mulhi_u32, barrett_reduce_u32,
)
from sorting_fhe_tpu.core.ntt import (
    NttContext, ntt_fwd, ntt_inv, negacyclic_convolve_reference,
)

RNG = np.random.default_rng(0)


def rand_u32(shape, bound):
    return RNG.integers(0, bound, size=shape, dtype=np.uint64).astype(np.uint32)


def test_prime_generation():
    n = 1 << 12
    primes = nt.find_ntt_primes(30, 5, n)
    assert len(set(primes)) == 5
    for p in primes:
        assert nt.is_prime(p)
        assert p % (2 * n) == 1
        assert p < (1 << 31)


def test_mulhi_u32():
    a = rand_u32((1000,), 1 << 32)
    b = rand_u32((1000,), 1 << 32)
    got = np.asarray(mulhi_u32(jnp.asarray(a), jnp.asarray(b)))
    want = ((a.astype(np.uint64) * b.astype(np.uint64)) >> 32).astype(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_mont_and_shoup_mul():
    p = nt.find_ntt_primes(30, 1, 1 << 10)[0]
    mc = nt.montgomery_constants(p)
    a = rand_u32((2048,), p)
    b = rand_u32((2048,), p)
    pj = jnp.uint32(p)
    # montgomery: inputs in mont domain -> output mont domain
    am = nt.to_montgomery_host(a, p)
    bm = nt.to_montgomery_host(b, p)
    got = np.asarray(mont_mul(jnp.asarray(am), jnp.asarray(bm), pj,
                              jnp.uint32(mc["neg_p_inv"])))
    got_plain = nt.from_montgomery_host(got, p)
    want = (a.astype(object) * b.astype(object) % p).astype(np.uint64)
    np.testing.assert_array_equal(got_plain.astype(np.uint64), want)
    # shoup: mont-domain x times plain constant keeps mont domain
    w = int(b[0])
    w_sh = (w << 32) // p
    got2 = np.asarray(shoup_mul(jnp.asarray(am), jnp.uint32(w),
                                jnp.uint32(w_sh), pj))
    got2_plain = nt.from_montgomery_host(got2, p)
    want2 = (a.astype(object) * w % p).astype(np.uint64)
    np.testing.assert_array_equal(got2_plain.astype(np.uint64), want2)


def test_add_sub_barrett():
    p = nt.find_ntt_primes(29, 1, 1 << 10)[0]
    a = rand_u32((512,), p)
    b = rand_u32((512,), p)
    pj = jnp.uint32(p)
    np.testing.assert_array_equal(
        np.asarray(add_mod(jnp.asarray(a), jnp.asarray(b), pj)),
        ((a.astype(np.uint64) + b) % p).astype(np.uint32))
    np.testing.assert_array_equal(
        np.asarray(sub_mod(jnp.asarray(a), jnp.asarray(b), pj)),
        ((a.astype(np.uint64) + p - b) % p).astype(np.uint32))
    x = rand_u32((512,), 1 << 32)
    pb = jnp.uint32((1 << 32) // p)
    np.testing.assert_array_equal(
        np.asarray(barrett_reduce_u32(jnp.asarray(x), pj, pb)),
        (x.astype(np.uint64) % p).astype(np.uint32))


@pytest.mark.parametrize("logn", [3, 8, 11])
def test_ntt_roundtrip(logn):
    n = 1 << logn
    primes = nt.find_ntt_primes(30, 3, n)
    ctx = NttContext(primes, n)
    a = np.stack([rand_u32((n,), p) for p in primes])
    aj = jnp.asarray(a)
    back = np.asarray(ntt_inv(ntt_fwd(aj, ctx), ctx))
    np.testing.assert_array_equal(back, a)


@pytest.mark.parametrize("logn", [3, 6])
def test_ntt_negacyclic_convolution(logn):
    n = 1 << logn
    p = nt.find_ntt_primes(28, 1, n)[0]
    ctx = NttContext([p], n)
    mc = nt.montgomery_constants(p)
    a = rand_u32((n,), p)
    b = rand_u32((n,), p)
    # device path in montgomery domain
    am = nt.to_montgomery_host(a, p)[None, :]
    bm = nt.to_montgomery_host(b, p)[None, :]
    fa = ntt_fwd(jnp.asarray(am), ctx)
    fb = ntt_fwd(jnp.asarray(bm), ctx)
    fc = mont_mul(fa, fb, jnp.uint32(p), jnp.uint32(mc["neg_p_inv"]))
    c = np.asarray(ntt_inv(fc, ctx))[0]
    c_plain = nt.from_montgomery_host(c, p)
    want = negacyclic_convolve_reference(a, b, p)
    np.testing.assert_array_equal(c_plain, want)


def test_ntt_batched_shapes():
    n = 1 << 5
    primes = nt.find_ntt_primes(28, 2, n)
    ctx = NttContext(primes, n)
    a = np.stack([np.stack([rand_u32((n,), p) for p in primes])
                  for _ in range(3)])  # [3, L, n]
    back = np.asarray(ntt_inv(ntt_fwd(jnp.asarray(a), ctx), ctx))
    np.testing.assert_array_equal(back, a)


def _oracle_rows(fn, x, primes):
    """Per-row host oracle (core/host_poly.py) over [..., L, n]."""
    from sorting_fhe_tpu.core.host_poly import host_ntt
    n = x.shape[-1]
    flat = x.reshape(-1, len(primes), n)
    out = np.stack([np.stack([getattr(host_ntt(p, n), fn)(row)
                              for row, p in zip(rows, primes)])
                    for rows in flat])
    return out.reshape(x.shape)


@pytest.mark.parametrize("case", ["row_subset", "lead_dims"])
def test_xla_ntt_matches_host_oracle(case):
    """ntt_fwd_t / ntt_inv_t against the host numpy oracle: on a
    non-prefix row subset of the table, and on [k, L, n] leading dims."""
    n = 256
    primes = nt.find_ntt_primes(28, 6, n)
    ctx = NttContext(primes, n)
    sel = np.array([4, 1, 5]) if case == "row_subset" else np.arange(3)
    ps = [primes[r] for r in sel]
    lead = (3,) if case == "lead_dims" else ()
    x = np.stack([rand_u32(lead + (n,), p) for p in ps], axis=-2)
    fwd = np.asarray(ntt_fwd(jnp.asarray(x), ctx, limb_idx=sel))
    inv = np.asarray(ntt_inv(jnp.asarray(x), ctx, limb_idx=sel))
    np.testing.assert_array_equal(fwd, _oracle_rows("fwd", x, ps))
    np.testing.assert_array_equal(inv, _oracle_rows("inv", x, ps))


@pytest.fixture(scope="module")
def small_ctx():
    from sorting_fhe_tpu.core.ckks import CkksContext, CkksConfig
    # comp=1 chains skip the composite prime-pool search
    return CkksContext(CkksConfig(ring_dim=1 << 8, mult_depth=6,
                                  scale_bits=26, comp=1, dnum=2))


@pytest.mark.parametrize("helper", ["fwd_ext", "inv_sp", "inv_q_dyn"])
def test_keyswitch_ntt_row_selection(small_ctx, helper):
    """The evaluator's row-set NTT helpers pick the right table rows:
    q rows of the level plus the special primes (_fwd_ext), the special
    primes (_inv_sp), one traced q row (_inv_q_dyn)."""
    from sorting_fhe_tpu.core import ckks as C
    P = small_ctx.params
    l = P.nq - 4                              # a level below the top
    T = small_ctx.tables(l)
    sp = list(range(P.nq, P.nq + P.num_special))
    rows, fn, call = {
        "fwd_ext": (list(range(l)) + sp, "fwd",
                    lambda x: C._fwd_ext(x, T)),
        "inv_sp": (sp, "inv", lambda x: C._inv_sp(x, T)),
        "inv_q_dyn": ([3], "inv",
                      lambda x: C._inv_q_dyn(x, T, jnp.int32(3))),
    }[helper]
    ps = [P.all_primes[r] for r in rows]
    x = np.stack([np.stack([rand_u32((small_ctx.n,), p) for p in ps])
                  for _ in range(2)])         # [k=2, rows, n]
    got = np.asarray(jax.jit(call)(jnp.asarray(x)))
    np.testing.assert_array_equal(got, _oracle_rows(fn, x, ps))
