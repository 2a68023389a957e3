"""CKKS crypto parameters and precomputed RNS tables.

One `CkksParams` object plays the role of OpenFHE's CryptoContext parameter
block for the reference (/root/reference/src/sort_algo.h:87-201 sets
multiplicative depth / scaling mod size / batch size; OpenFHE derives the
prime chain).  Here we generate the chain ourselves:

* q_0 .. q_L        "ciphertext" primes: q_0 is the large base prime
                    (decryption headroom), q_1..q_L are rescaling primes
                    close to 2^scale_bits.
* p_0 .. p_{k-1}    special primes for hybrid key switching.

All primes are NTT-friendly (≡ 1 mod 2n) and < 2^31 so device arithmetic
stays in uint32 (see rns.py).  The reference uses 40-60 bit primes via
OpenFHE; here more, narrower limbs keep every product inside a 32x32-bit
multiply.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field

import numpy as np
import jax.numpy as jnp

from . import nt
from .ntt import NttContext


@dataclass(frozen=True)
class CkksConfig:
    """User-facing knobs, analogous to CCParams<CryptoContextCKKSRNS>.

    `scale_bits` is the TOTAL log2 of the scaling factor Delta per
    multiplicative level; `comp` primes of ~scale_bits/comp bits realise it
    (composite scaling — the uint32-RNS answer to OpenFHE's 40-60 bit
    primes: with 31-bit limbs a deep-precision level is a *pair* of
    ~26-29-bit primes dropped together at rescale).
    """
    ring_dim: int = 1 << 13
    mult_depth: int = 10
    scale_bits: int = 29          # total log2(Delta) per level
    comp: int = 1                 # primes per level (composite degree)
    base_mod_bits: int = 30       # size of each base ("first modulus") prime
    dnum: int = 3                 # hybrid key-switch digit count
    num_special_primes: int | None = None  # default: ceil(nq/dnum)
    # rotation-key device-memory budget (MB): None keeps every generated
    # key resident (dict semantics); a value caps resident rotation keys in
    # a device LRU with deterministic on-demand regeneration
    # (core/keystore.py) — for pipelines whose key set outgrows device
    # memory (e.g. MEHP24 N>=32 at ring 2^17 needs ~20-35 keys x ~0.5 GB)
    rot_key_budget_mb: int | None = None
    seed: int = 2024
    sigma: float = 3.19           # error stddev
    batch_size: int | None = None  # default n/2 slots
    # secret key Hamming weight: None = uniform ternary; an int enables the
    # sparse-ternary secret bootstrapping needs (core/bootstrap.py)
    secret_hw: int | None = None
    # limb-count bucketing: pad ciphertext towers to the next multiple of
    # `limb_pad` limbs inside the jitted kernels, collapsing the ~L distinct
    # limb counts of a deep chain to ~L/limb_pad compiled shapes per kernel
    # (~46 limb counts x ~8 kernels at depth 46, each a separate XLA
    # compile).  Rows in [logical_limbs, bucket) hold garbage
    # residues of SOME value ≡ the ciphertext mod Q_l — every kernel is
    # residue-wise mod arithmetic, so results sliced to the logical limbs
    # are exact.  1 = exact shapes (no padding).
    limb_pad: int = 1


# legacy alias: minimum base limbs (actual value is params.base_limbs)
BASE_LIMBS = 2


class CkksParams:
    """Derived parameter set + device-resident tables."""

    def __init__(self, cfg: CkksConfig):
        self.cfg = cfg
        n = cfg.ring_dim
        self.n = n
        self.num_slots = cfg.batch_size or (n // 2)
        L = cfg.mult_depth          # number of rescaling primes
        self.L = L

        # prime chain: base primes (decryption floor able to hold
        # max_value * Delta), then L levels of `comp` rescaling primes each,
        # chosen adaptively (per-level product nearest S^2/Delta walking down
        # from the top) so the canonical scale stays anchored at Delta —
        # without this, scale deviation doubles every level and adds break.
        comp = cfg.comp
        self.comp = comp
        self.base_limbs = max(2, -(-(cfg.scale_bits + 20) // cfg.base_mod_bits))
        base = nt.find_ntt_primes(cfg.base_mod_bits, self.base_limbs, n)
        delta = float(2 ** cfg.scale_bits)
        avoid = set(base)
        qs_rev = []  # built top-down: first entries dropped first
        S = delta
        if comp == 2:
            # Pool-based PAIR picker.  Balanced sub_bits pairs exhaust the
            # sparse mid-size NTT primes on deep chains (at ring 2^17 only
            # ~10 26-bit primes exist) and the ladder recursion
            # S' = S^2/prod then diverges double-exponentially.  Instead
            # pick, per level, the remaining-pool PAIR whose product is
            # nearest S^2/Delta — unbalanced splits like 29+27 tap the
            # dense top of the pool and keep |log2(S/Delta)| ~ 2^-10
            # down the whole chain.
            import bisect
            pool = [p for p in nt.ntt_prime_pool(n) if p not in avoid]
            for _ in range(L):
                target = S * S / delta
                lt = math.log2(target)
                best = None
                for i, p1 in enumerate(pool):
                    ideal = target / p1
                    if ideal < pool[0] * 0.5:
                        break              # pool ascending: only worse
                    if ideal >= (1 << 31):
                        continue
                    j = bisect.bisect_left(pool, int(ideal))
                    for jj in (j - 1, j, j + 1):
                        if jj < 0 or jj >= len(pool) or jj == i:
                            continue
                        p2 = pool[jj]
                        err = abs(math.log2(p1) + math.log2(p2) - lt)
                        if best is None or err < best[0]:
                            best = (err, p1, p2)
                assert best is not None, "NTT prime pool exhausted"
                _, p1, p2 = best
                pool.remove(p1)
                pool.remove(p2)
                # smaller prime drops second (order within level arbitrary)
                level_primes = sorted((p1, p2), reverse=True)
                S = S * S / (float(p1) * float(p2))
                qs_rev.extend(level_primes)
        else:
            sub_bits = cfg.scale_bits / comp
            for _ in range(L):
                target = S * S / delta      # product this level must hit
                level_primes = []
                for j in range(comp):
                    if j < comp - 1:
                        p = nt.nearest_ntt_prime(2.0 ** sub_bits, n, avoid)
                    else:
                        rem = target
                        for pp in level_primes:
                            rem /= pp
                        p = nt.nearest_ntt_prime(rem, n, avoid)
                    avoid.add(p)
                    level_primes.append(p)
                prod = 1.0
                for pp in level_primes:
                    prod *= pp
                S = S * S / prod
                # drop order within the level is arbitrary; append in order
                qs_rev.extend(level_primes)
        self.q: list[int] = base + qs_rev[::-1]
        self.nq = len(self.q)

        alpha = -(-self.nq // cfg.dnum)      # limbs per digit
        k = cfg.num_special_primes or alpha
        self.alpha = alpha
        self.num_special = k
        # special primes: as large as possible (< 2^31) to minimize their
        # count's noise contribution
        self.p_special: list[int] = nt.find_ntt_primes(
            30, k, n, avoid=tuple(self.q))

        self.all_primes: list[int] = self.q + self.p_special
        self.ntt = NttContext(self.all_primes, n)

        # Montgomery constants per prime, as device arrays [num_primes]
        mont = [nt.montgomery_constants(p) for p in self.all_primes]
        self.mont_neg_p_inv = jnp.asarray(
            np.array([m["neg_p_inv"] for m in mont], dtype=np.uint32))
        self.primes_dev = jnp.asarray(
            np.array(self.all_primes, dtype=np.uint32))
        self.r2 = [m["r2"] for m in mont]

        # P mod q_i and P^{-1} mod q_i for ModDown
        P = 1
        for p in self.p_special:
            P *= p
        self.P_int = P
        self.P_mod_q = [P % q for q in self.q]
        self.P_inv_mod_q = [nt.mod_inverse(P % q, q) for q in self.q]

        # canonical scaling factors per level-boundary limb count
        # (FLEXIBLEAUTO-style): fresh ciphertexts live at nq limbs with
        # scale Delta; a (composite) rescale drops `comp` primes and the
        # canonical scale one level down is S' = S^2 / prod(dropped).
        S = {self.nq: delta}
        limbs = self.nq
        while limbs > self.base_limbs:
            prod = 1.0
            for i in range(limbs - comp, limbs):
                prod *= float(self.q[i])
            S[limbs - comp] = S[limbs] * S[limbs] / prod
            limbs -= comp
        self.canonical_scale = S

        self.Q_int = functools.reduce(lambda a, b: a * b, self.q, 1)

    # ---- host-side helpers ----
    def q_product(self, num_limbs: int) -> int:
        """Product of the first num_limbs q primes."""
        out = 1
        for i in range(num_limbs):
            out *= self.q[i]
        return out

    def describe(self) -> str:
        return (f"CKKS n=2^{self.n.bit_length()-1} L={self.L} "
                f"scale=2^{self.cfg.scale_bits} dnum={self.cfg.dnum} "
                f"|q|={len(self.q)} |p|={len(self.p_special)} "
                f"logQP={sum(p.bit_length() for p in self.all_primes)}")
