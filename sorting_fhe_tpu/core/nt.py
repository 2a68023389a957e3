"""Host-side number theory: primes, roots of unity, modular helpers.

All functions here run on the host in pure Python / numpy (client-side of the
FHE protocol).  Device-side modular arithmetic lives in :mod:`.rns`.

JAX-side rebuild of the parameter-generation layer the reference delegates
to OpenFHE (reference: /root/reference/src/sort_algo.h:87-201 chooses depth /
scaleMod; OpenFHE generates the actual prime chain internally).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

_SMALL_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37]


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24 (covers all 64-bit ints)."""
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _SMALL_PRIMES:
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def mod_inverse(a: int, m: int) -> int:
    return pow(a, -1, m)


def _prime_factors(n: int) -> list[int]:
    out = []
    d = 2
    while d * d <= n:
        if n % d == 0:
            out.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        out.append(n)
    return out


@lru_cache(maxsize=None)
def primitive_root(p: int) -> int:
    """Smallest generator of (Z/p)^*."""
    factors = _prime_factors(p - 1)
    g = 2
    while True:
        if all(pow(g, (p - 1) // f, p) != 1 for f in factors):
            return g
        g += 1


def root_of_unity(order: int, p: int) -> int:
    """A primitive `order`-th root of unity mod p (requires order | p-1)."""
    assert (p - 1) % order == 0, f"{order} does not divide {p}-1"
    g = primitive_root(p)
    w = pow(g, (p - 1) // order, p)
    assert pow(w, order, p) == 1 and pow(w, order // 2, p) == p - 1
    return w


def find_ntt_primes(bits: int, count: int, ring_dim: int,
                    avoid: tuple[int, ...] = ()) -> list[int]:
    """`count` primes of ~`bits` bits with p ≡ 1 (mod 2*ring_dim).

    Walks downward from 2^bits so primes are as close to 2^bits as possible
    (keeps the CKKS scaling factor drift small, like OpenFHE's prime
    selection for FLEXIBLEAUTO rescaling).  Alternates above/below 2^bits to
    balance the scale.
    """
    m = 2 * ring_dim
    out: list[int] = []
    avoid_set = set(avoid)
    # candidates p = k*m + 1 near 2^bits, alternate below/above
    k0 = (1 << bits) // m
    lo, hi = k0, k0 + 1
    toggle = True
    while len(out) < count:
        k = lo if toggle else hi
        if toggle:
            lo -= 1
        else:
            hi += 1
        toggle = not toggle
        p = k * m + 1
        if p < (1 << (bits - 1)) or p >= (1 << 31):
            if p >= (1 << 31):
                continue  # keep walking downward candidates
            raise RuntimeError(f"ran out of {bits}-bit NTT primes")
        if p in avoid_set:
            continue
        if is_prime(p):
            out.append(p)
            avoid_set.add(p)
    return out


def nearest_ntt_prime(target: float, ring_dim: int,
                      avoid: set[int]) -> int:
    """NTT-friendly prime (≡ 1 mod 2*ring_dim, < 2^31) nearest to `target`.

    Used to build the rescaling chain FLEXIBLEAUTO-style: each level's prime
    is chosen nearest S_l^2 / Delta so the canonical per-level scaling
    factors stay anchored at Delta instead of drifting geometrically.
    """
    m = 2 * ring_dim
    k0 = max(1, int(round(target / m)))
    for d in range(0, 1 << 22):
        for k in ((k0 + d, k0 - d) if d else (k0,)):
            if k < 1:
                continue
            p = k * m + 1
            if p >= (1 << 31) or p < (1 << 20):
                continue
            if p in avoid:
                continue
            if is_prime(p):
                return p
    raise RuntimeError(f"no NTT prime near {target}")


@lru_cache(maxsize=None)
def ntt_prime_pool(ring_dim: int, max_bits: int = 31) -> tuple[int, ...]:
    """ALL NTT-friendly primes (≡ 1 mod 2*ring_dim) below 2^max_bits,
    ascending.

    The composite-rescale chain builder consumes from this global pool:
    at ring 2^17 primes are ~2^18 apart, so e.g. only ~10 26-bit primes
    exist — a deep chain that insists on balanced 26+26-bit level pairs
    EXHAUSTS them and the canonical-scale ladder death-spirals (observed
    at depth 46: canonical scales ran to 2^-1000 below limb 21)."""
    m = 2 * ring_dim
    out = []
    k = 1
    while True:
        p = k * m + 1
        if p >= (1 << max_bits):
            break
        if p > (1 << 19) and is_prime(p):
            out.append(p)
        k += 1
    return tuple(out)


def bit_reverse_indices(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def power_table(base: int, n: int, p: int) -> np.ndarray:
    """[1, base, base^2, ..., base^(n-1)] mod p as uint64, via doubling."""
    out = np.ones(n, dtype=np.uint64)
    block = 1
    pp = np.uint64(p)
    while block < n:
        step = np.uint64(pow(base, block, p))
        end = min(2 * block, n)
        out[block:end] = out[: end - block] * step % pp
        block *= 2
    return out


def make_ntt_tables(p: int, n: int) -> dict[str, np.ndarray]:
    """Twiddle tables for the negacyclic NTT (Longa–Naehrig iterative form).

    Returns plain-domain twiddles (psi powers in bit-reversed order) plus
    their Shoup precomputations, and n^{-1} folded constants for the inverse.
    All arrays are uint32; Shoup companion = floor(w * 2^32 / p).
    """
    psi = root_of_unity(2 * n, p)
    psi_inv = mod_inverse(psi, p)
    rev = bit_reverse_indices(n)

    # power tables by doubling: log2(n) vectorized passes; products stay
    # < 2^62 (p < 2^31) so plain uint64 modular math suffices
    tmp = power_table(psi, n, p)
    tmpi = power_table(psi_inv, n, p)
    pw = tmp[rev]
    pwi = tmpi[rev]

    n_inv = mod_inverse(n, p)

    def shoup(w: np.ndarray) -> np.ndarray:
        # w < 2^31 so (w << 32) < 2^63 fits in uint64
        return (w << np.uint64(32)) // np.uint64(p)

    return {
        "psi_brv": pw.astype(np.uint32),
        "psi_brv_shoup": shoup(pw).astype(np.uint32),
        "ipsi_brv": pwi.astype(np.uint32),
        "ipsi_brv_shoup": shoup(pwi).astype(np.uint32),
        "n_inv": np.uint32(n_inv),
        "n_inv_shoup": np.uint32((n_inv << 32) // p),
    }


def montgomery_constants(p: int) -> dict[str, int]:
    """Montgomery (R = 2^32) constants for prime p < 2^31."""
    r = 1 << 32
    p_inv = mod_inverse(p, r)          # p * p_inv ≡ 1 (mod 2^32)
    neg_p_inv = (-p_inv) % r           # used in REDC: m = t_lo * neg_p_inv
    r_mod = r % p
    r2 = r_mod * r_mod % p
    return {"neg_p_inv": neg_p_inv, "r_mod": r_mod, "r2": r2}


def to_montgomery_host(x: np.ndarray, p: int) -> np.ndarray:
    """Host-side conversion value -> value*R mod p (numpy object/u64 math)."""
    r_mod = (1 << 32) % p
    return (x.astype(object) * r_mod % p).astype(np.uint64).astype(np.uint32)


def from_montgomery_host(x: np.ndarray, p: int) -> np.ndarray:
    rinv = mod_inverse((1 << 32) % p, p)
    return (x.astype(object) * rinv % p).astype(np.uint64).astype(np.uint32)
