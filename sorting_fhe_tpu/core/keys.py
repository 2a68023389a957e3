"""Client-side key generation, encryption and decryption (host numpy).

Implements the OpenFHE surface the reference consumes: KeyGen,
EvalMultKeyGen (relinearization), EvalRotateKeyGen (Galois keys), Encrypt,
Decrypt (reference test setup: /root/reference/tests/DirectSortTest.cpp:27-57).

Hybrid key-switching keys: the q-chain is split into `dnum` digits of
`alpha` primes; `alpha` special primes P extend the basis.  Key for secret
s' under s, digit j:

    ksk_j = (b_j, a_j),  b_j = -a_j s + e_j + P * W_j * s'  (mod QP)

with W_j = (Q/D_j) * [(Q/D_j)^{-1}]_{D_j} the CRT reconstruction weight of
digit j.  All key material is shipped to the device in NTT + Montgomery
form, shaped [dnum, 2, num_rows, n] with rows = q primes then special
primes.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from . import nt
from .host_poly import (
    host_ntt, sample_ternary, sample_gaussian, rns_to_centered_bigint,
)
from .params import CkksParams


def _to_mont(x: np.ndarray, p: int) -> np.ndarray:
    r = (1 << 32) % p
    return (x.astype(np.uint64) * r % p)


def _ntt_all(coeffs_signed: np.ndarray, primes: list[int], n: int,
             mont: bool = True) -> np.ndarray:
    """Small signed poly -> [len(primes), n] u64 NTT (+Montgomery) domain."""
    out = np.empty((len(primes), n), dtype=np.uint64)
    for i, p in enumerate(primes):
        r = (coeffs_signed % p).astype(np.uint64)
        r = host_ntt(p, n).fwd(r)
        out[i] = _to_mont(r, p) if mont else r
    return out


class _LazySNtt(dict):
    """Per-prime plain-domain NTT of the secret, computed on demand."""

    def __init__(self, coeffs: np.ndarray, n: int):
        super().__init__()
        self._coeffs = coeffs
        self._n = n

    def __missing__(self, p: int):
        r = (self._coeffs % p).astype(np.uint64)
        v = host_ntt(p, self._n).fwd(r)
        self[p] = v
        return v


class SecretKey:
    def __init__(self, params: CkksParams, rng: np.random.Generator):
        self.params = params
        self.s_coeffs = sample_ternary(params.n, rng, params.cfg.secret_hw)
        self.s_ntt = _LazySNtt(self.s_coeffs, params.n)


class KeyGenerator:
    """Generates all key material; holds the secret (client side only)."""

    def __init__(self, params: CkksParams, seed: int | None = None):
        self.params = params
        self.rng = np.random.default_rng(
            params.cfg.seed if seed is None else seed)
        self.sk = SecretKey(params, self.rng)
        self._pk = self._gen_public_key()

    # ---------------- public / encryption keys ----------------
    def _gen_public_key(self):
        P = self.params
        n = P.n
        qs = P.q
        e = sample_gaussian(n, P.cfg.sigma, self.rng)
        b = np.empty((len(qs), n), dtype=np.uint64)
        a = np.empty((len(qs), n), dtype=np.uint64)
        for i, p in enumerate(qs):
            ai = self.rng.integers(0, p, size=n, dtype=np.uint64)  # NTT dom
            s = self.sk.s_ntt[p]
            en = host_ntt(p, n).fwd((e % p).astype(np.uint64))
            bi = (p - ai * s % p + en) % p
            b[i] = bi
            a[i] = ai
        return b, a

    # ---------------- key switching keys ----------------
    def _digit_indices(self) -> list[list[int]]:
        P = self.params
        nq = len(P.q)
        alpha = P.alpha
        return [list(range(j * alpha, min((j + 1) * alpha, nq)))
                for j in range(-(-nq // alpha))]

    def gen_ksk(self, s_prime_coeffs: np.ndarray) -> np.ndarray:
        """Key switching key for s' -> s: u32 [dnum, 2, nq + nsp, n],
        NTT+Montgomery domain.

        Assembled ON DEVICE as a single jitted kernel (batched NTTs over
        all rows): at ring 2^17 with ~100 limbs a host-loop keygen would
        take hours.  The uniform and error polynomials are sampled on the
        host from the seeded generator."""
        P = self.params
        n = P.n
        qs = P.q
        sp = P.p_special
        rows = qs + sp
        nrows = len(rows)
        dnum = len(self._digit_indices())
        rows_i64 = np.array(rows, dtype=np.int64)
        if not hasattr(self, "_s_red"):
            self._s_red = jnp.asarray(
                (self.sk.s_coeffs[None, :] % rows_i64[:, None])
                .astype(np.uint32))

        sp_red = jnp.asarray(
            (np.asarray(s_prime_coeffs, dtype=np.int64)[None, :]
             % rows_i64[:, None]).astype(np.uint32))

        # uniform a (Montgomery-domain uniform == uniform); host PRNG for
        # reproducibility via a seed
        a_all = np.empty((dnum, nrows, n), dtype=np.uint32)
        for r, p in enumerate(rows):
            a_all[:, r, :] = self.rng.integers(
                0, p, size=(dnum, n), dtype=np.uint64).astype(np.uint32)

        e_all = np.stack([sample_gaussian(n, P.cfg.sigma, self.rng)
                          for _ in range(dnum)])       # [dnum, n] signed
        e_red = (e_all[:, None, :] %
                 rows_i64[None, :, None]).astype(np.uint32)

        # per-digit reconstruction weights P*W_j mod each row prime (Shoup)
        w, wsh, rmod, rsh = self._ksk_weights()
        return _ksk_kernel(self._s_red, sp_red, jnp.asarray(a_all),
                           jnp.asarray(e_red), w, wsh, rmod, rsh, P.ntt.p,
                           P.ntt.psi, P.ntt.psi_sh, P.mont_neg_p_inv)

    def _ksk_weights(self):
        """(w, wsh, rmod, rsh) Shoup tables for KSK assembly — independent
        of the switched secret s', cached across keys."""
        if hasattr(self, "_ksk_w_cache"):
            return self._ksk_w_cache
        P = self.params
        qs = P.q
        sp = P.p_special
        rows = qs + sp
        nrows = len(rows)
        digits = self._digit_indices()
        dnum = len(digits)
        Pint = P.P_int
        Q = 1
        for q in qs:
            Q *= q
        w = np.empty((dnum, nrows), dtype=np.uint32)
        wsh = np.empty((dnum, nrows), dtype=np.uint32)
        for j, dig in enumerate(digits):
            Dj = 1
            for i in dig:
                Dj *= qs[i]
            Dhat = Q // Dj
            Wj = Dhat * nt.mod_inverse(Dhat % Dj, Dj)
            for r, p in enumerate(rows):
                c = (Pint % p) * (Wj % p) % p
                w[j, r] = c
                wsh[j, r] = (c << 32) // p
        rmod = np.array([(1 << 32) % p for p in rows], dtype=np.uint32)
        rsh = np.array([(int(r) << 32) // p
                        for r, p in zip(rmod, rows)], dtype=np.uint32)
        self._ksk_w_cache = (jnp.asarray(w), jnp.asarray(wsh),
                             jnp.asarray(rmod), jnp.asarray(rsh))
        return self._ksk_w_cache

    def gen_rotation_key_dev(self, g: int) -> "jnp.ndarray":
        """Galois key generated ENTIRELY on device with a deterministic
        per-(seed, g) PRNG: regenerating the same g yields the
        bit-identical key, which makes KeyStore eviction transparent
        (core/keystore.py).  Only the [n] small rotated-secret poly
        crosses the host->device link (~0.5 MB), vs the host-PRNG path's
        ~[dnum, nrows, n] uniform tensor (~0.3 GB per key)."""
        import jax

        from .encoding import automorphism_index_table
        P = self.params
        src, sign = automorphism_index_table(P.n, g)
        s_rot = (sign * self.sk.s_coeffs[src]).astype(np.int32)
        w, wsh, rmod, rsh = self._ksk_weights()
        if not hasattr(self, "_s_red"):
            rows_i64 = np.array(P.q + P.p_special, dtype=np.int64)
            self._s_red = jnp.asarray(
                (self.sk.s_coeffs[None, :] % rows_i64[:, None])
                .astype(np.uint32))
        key = jax.random.fold_in(
            jax.random.PRNGKey(P.cfg.seed ^ 0x5EED), g)
        return _ksk_kernel_dev(
            key, self._s_red, jnp.asarray(s_rot), w, wsh, rmod, rsh,
            P.ntt.p, P.mont_neg_p_inv, jnp.float32(P.cfg.sigma),
            P.ntt.psi, P.ntt.psi_sh)

    def gen_relin_key(self) -> np.ndarray:
        # s^2 mod (X^n + 1) has coefficients bounded by n < p/2, so a single
        # NTT prime recovers them exactly via centered lift.
        s2 = _negacyclic_square_int(self.sk.s_coeffs, self.params.q[0],
                                    self.params.n)
        return self.gen_ksk(s2)

    def gen_rotation_key(self, g: int) -> np.ndarray:
        """Galois key for element g (sigma_g(s) -> s)."""
        from .encoding import automorphism_index_table
        src, sign = automorphism_index_table(self.params.n, g)
        s_rot = sign * self.sk.s_coeffs[src]
        return self.gen_ksk(s_rot)

    @property
    def public_key(self):
        return self._pk


def _negacyclic_square_int(s: np.ndarray, p: int, n: int) -> np.ndarray:
    """Exact s*s mod (X^n+1) for ternary s via one NTT prime + centered lift
    (coefficients are bounded by n << p/2)."""
    hp = host_ntt(p, n)
    sn = hp.fwd((s % p).astype(np.uint64))
    s2 = hp.inv(sn * sn % p).astype(np.int64)
    return np.where(s2 > p // 2, s2 - p, s2)


def _ksk_kernel_body(s_red, sp_red, a, e_red, w, wsh, rmod, rsh,
                     p, psi, psi_sh, npi):
    """Device-side KSK assembly: b = e - a*s + P*W_j*s' (all NTT+Mont).

    s_red/sp_red: [nrows, n] plain residues; a: [dnum, nrows, n] uniform
    (treated as Montgomery-domain, still uniform); e_red: [dnum, nrows, n];
    w/wsh: [dnum, nrows] Shoup pairs for P*W_j folded with R; psi/psi_sh:
    forward-NTT tables of all rows."""
    import jax.numpy as jnp
    from .ntt import ntt_fwd_t
    from .rns import mont_mul, shoup_mul, add_mod, sub_mod

    fwd = lambda x: ntt_fwd_t(x, p, psi, psi_sh)
    p1 = p.reshape(-1, 1)
    p2 = p.reshape(1, -1, 1)
    npi2 = npi.reshape(1, -1, 1)
    to_mont1 = lambda x: shoup_mul(x, rmod.reshape(-1, 1),
                                   rsh.reshape(-1, 1), p1)
    s_ntt = fwd(to_mont1(s_red))
    sp_ntt = fwd(to_mont1(sp_red))
    e_m = shoup_mul(e_red, rmod.reshape(1, -1, 1), rsh.reshape(1, -1, 1), p2)
    e_ntt = fwd(e_m)
    term = shoup_mul(sp_ntt[None], w[:, :, None], wsh[:, :, None], p2)
    asl = mont_mul(a, s_ntt[None], p2, npi2)
    b = add_mod(sub_mod(e_ntt, asl, p2), term, p2)
    return jnp.stack([b, a], axis=1)                   # [dnum, 2, nrows, n]


def _ksk_dev_body(key, s_red, srot_small, w, wsh, rmod, rsh, p, npi,
                  sigma, psi, psi_sh):
    """Device-PRNG KSK assembly, STREAMED per digit with lax.map: the
    whole-key draw held a ~1 GB bits tensor plus ~2 GB of intermediates
    live at once, which ran bootstrap-heavy sorts that regenerate keys
    mid-flight out of device memory.  Per-digit transients are ~8x
    smaller; PRNG streams are split deterministically per digit so keys
    stay bit-reproducible across regenerations."""
    import jax
    import jax.numpy as jnp
    from .ntt import ntt_fwd_t
    from .rns import add_mod, sub_mod, shoup_mul, mont_mul

    fwd = lambda x: ntt_fwd_t(x, p, psi, psi_sh)
    nrows = s_red.shape[0]
    n = srot_small.shape[0]
    p1 = p.reshape(-1, 1)
    npi1 = npi.reshape(-1, 1)
    p_i32 = p.astype(jnp.int32)
    to_mont = lambda x: shoup_mul(x, rmod.reshape(-1, 1),
                                  rsh.reshape(-1, 1), p1)
    s_ntt = fwd(to_mont(s_red))
    sp_red = jnp.where(srot_small[None, :] < 0,
                       p_i32.reshape(-1, 1) + srot_small[None, :],
                       srot_small[None, :]).astype(jnp.uint32)
    sp_ntt = fwd(to_mont(sp_red))

    dnum = w.shape[0]
    dkeys = jax.random.split(key, dnum)

    def per_digit(args):
        kj, w_j, wsh_j = args
        kb, ke = jax.random.split(kj)
        bits = jax.random.bits(kb, (2, nrows, n), jnp.uint32)
        # uniform a: 64-bit draw folded mod p (bias ~p/2^64)
        a_j = add_mod(shoup_mul(bits[0], rmod.reshape(-1, 1),
                                rsh.reshape(-1, 1), p1),
                      jnp.remainder(bits[1], p1), p1)
        e = jnp.round(jax.random.normal(ke, (n,), jnp.float32)
                      * sigma).astype(jnp.int32)
        e_red = jnp.where(e[None, :] < 0, p_i32.reshape(-1, 1) + e[None, :],
                          e[None, :]).astype(jnp.uint32)
        e_ntt = fwd(to_mont(e_red))
        term = shoup_mul(sp_ntt, w_j.reshape(-1, 1), wsh_j.reshape(-1, 1),
                         p1)
        asl = mont_mul(a_j, s_ntt, p1, npi1)
        b = add_mod(sub_mod(e_ntt, asl, p1), term, p1)
        return jnp.stack([b, a_j])                    # [2, nrows, n]

    return jax.lax.map(per_digit, (dkeys, w, wsh))    # [dnum, 2, nrows, n]


import jax as _jax  # noqa: E402
_ksk_kernel = _jax.jit(_ksk_kernel_body)
_ksk_kernel_dev = _jax.jit(_ksk_dev_body)


class Encryptor:
    """Public-key encryptor (host side)."""

    def __init__(self, params: CkksParams, public_key, rng=None):
        self.params = params
        self.pk = public_key
        self.rng = rng or np.random.default_rng(params.cfg.seed + 1)

    def encrypt_coeffs(self, coeffs: np.ndarray) -> np.ndarray:
        """Integer coefficient poly (float64 or object) -> [2, nq, n] u32
        NTT+Montgomery ciphertext data at full level."""
        P = self.params
        n = P.n
        qs = P.q
        b, a = self.pk
        u = sample_ternary(n, self.rng)
        e0 = sample_gaussian(n, P.cfg.sigma, self.rng)
        e1 = sample_gaussian(n, P.cfg.sigma, self.rng)
        out = np.empty((2, len(qs), n), dtype=np.uint32)
        for i, p in enumerate(qs):
            hp = host_ntt(p, n)
            un = hp.fwd((u % p).astype(np.uint64))
            e0n = hp.fwd((e0 % p).astype(np.uint64))
            e1n = hp.fwd((e1 % p).astype(np.uint64))
            if coeffs.dtype == object:
                mc = (coeffs % p).astype(np.uint64)
            else:
                r = np.fmod(coeffs, float(p))
                mc = np.where(r < 0, r + p, r).astype(np.uint64)
            mn = hp.fwd(mc)
            c0 = (b[i] * un + e0n + mn) % p
            c1 = (a[i] * un + e1n) % p
            out[0, i] = _to_mont(c0, p).astype(np.uint32)
            out[1, i] = _to_mont(c1, p).astype(np.uint32)
        return out


class Decryptor:
    """Secret-key decryptor (host side, client/debug only)."""

    def __init__(self, params: CkksParams, sk: SecretKey):
        self.params = params
        self.sk = sk

    def decrypt_to_coeffs(self, data: np.ndarray, num_limbs: int,
                          max_limbs: int = 3) -> np.ndarray:
        """[>=2, limbs, n] u32 NTT+Mont ciphertext -> centered big-int
        coefficient array (object dtype).  Uses only the first
        min(num_limbs, max_limbs) limbs (mod-reduction is free)."""
        P = self.params
        n = P.n
        use = min(num_limbs, max_limbs)
        limbs = np.empty((use, n), dtype=np.uint64)
        k = data.shape[0]
        for i in range(use):
            p = P.q[i]
            hp = host_ntt(p, n)
            rinv = nt.mod_inverse((1 << 32) % p, p)
            acc = data[0, i].astype(np.uint64) * rinv % p
            spow = self.sk.s_ntt[p]
            si = spow.copy()
            for comp in range(1, k):
                ci = data[comp, i].astype(np.uint64) * rinv % p
                acc = (acc + ci * si) % p
                if comp + 1 < k:
                    si = si * spow % p
            limbs[i] = hp.inv(acc)
        return rns_to_centered_bigint(limbs, P.q[:use])
