"""Device-side RNS modular arithmetic in pure uint32 jax.numpy.

Every wide operation is built from 16-bit digit splits of uint32 values
(mulhi emulation, no 64-bit integer type needed), Montgomery reduction for
variable x variable products, and Shoup multiplication for variable x
constant products.  These functions are plain jnp code that XLA fuses into
the surrounding op.  Whether a native 32x32->64 product is faster on the
GPU is not measured yet.

Conventions
-----------
* primes p < 2^31 so a+b never overflows uint32 and products split cleanly.
* Device-resident polynomial data is kept in the Montgomery domain
  (stored value = v * 2^32 mod p).  `mont_mul(a, b)` then returns the
  Montgomery form of the product directly.
* Constants multiplied via Shoup are stored in the *plain* domain together
  with their Shoup companion floor(w * 2^32 / p); multiplying a Montgomery
  value by a plain constant keeps the result in the Montgomery domain.

This layer replaces the intrinsics OpenFHE's DCRTPoly provides to the
reference (/root/reference uses OpenFHE for all modular arithmetic; see
SURVEY.md L0).
"""

from __future__ import annotations

import jax.numpy as jnp

# plain int literal: weak-typed in jnp ops
U16_MASK = 0xFFFF


def mulhi_u32(a, b):
    """High 32 bits of the 64-bit product of two uint32 arrays."""
    a = a.astype(jnp.uint32)
    b = b.astype(jnp.uint32)
    a0 = a & U16_MASK
    a1 = a >> 16
    b0 = b & U16_MASK
    b1 = b >> 16
    lolo = a0 * b0
    m1 = a1 * b0 + (lolo >> 16)            # <= (2^15-1)(2^16-1) + 2^16 < 2^31
    m2 = a0 * b1 + (m1 & U16_MASK)
    return a1 * b1 + (m1 >> 16) + (m2 >> 16)


def add_mod(a, b, p):
    """(a + b) mod p for a, b in [0, p), p < 2^31."""
    s = a + b
    return jnp.where(s >= p, s - p, s)


def sub_mod(a, b, p):
    """(a - b) mod p for a, b in [0, p)."""
    s = a + p - b
    return jnp.where(s >= p, s - p, s)


def neg_mod(a, p):
    """(-a) mod p."""
    return jnp.where(a == 0, a, p - a)


def mont_mul(a, b, p, neg_p_inv):
    """Montgomery product a*b*2^-32 mod p (inputs/outputs in [0, p)).

    If a and b are in the Montgomery domain the result is the Montgomery
    form of the plain product.
    """
    t_lo = a * b
    t_hi = mulhi_u32(a, b)
    m = t_lo * neg_p_inv                   # mod 2^32
    mp_hi = mulhi_u32(m, p)
    # t_lo + m*p ≡ 0 (mod 2^32): carry out is 1 unless t_lo == 0
    carry = (t_lo != 0).astype(jnp.uint32)
    u = t_hi + mp_hi + carry
    return jnp.where(u >= p, u - p, u)


def shoup_mul(x, w, w_shoup, p):
    """x * w mod p with precomputed w_shoup = floor(w * 2^32 / p).

    w must be in [0, p).  x in [0, p).  Result in [0, p).
    6 32-bit multiplies; preferred for twiddles / plaintext constants / keys.
    """
    q = mulhi_u32(x, w_shoup)
    r = x * w - q * p                      # mod 2^32 arithmetic; r in [0, 2p)
    return jnp.where(r >= p, r - p, r)


def mont_reduce(t_hi, t_lo, p, neg_p_inv):
    """REDC of a 64-bit value given as (hi, lo): t * 2^-32 mod p."""
    m = t_lo * neg_p_inv
    mp_hi = mulhi_u32(m, p)
    carry = (t_lo != 0).astype(jnp.uint32)
    u = t_hi + mp_hi + carry
    return jnp.where(u >= p, u - p, u)


def barrett_reduce_u32(x, p, p_barrett):
    """x mod p for full-range uint32 x, p_barrett = floor(2^32 / p).

    Valid for p in (2^15, 2^31); result in [0, p).
    """
    q = mulhi_u32(x, p_barrett)
    r = x - q * p
    r = jnp.where(r >= p, r - p, r)
    return jnp.where(r >= p, r - p, r)
