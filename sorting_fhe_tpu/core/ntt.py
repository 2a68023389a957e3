"""Negacyclic NTT over RNS limbs, as plain batched XLA operations.

Forward transform: iterative Cooley-Tukey (decimation in time) with the
2n-th root psi merged into the twiddles (Longa–Naehrig form), natural input
order, bit-reversed output order.  Inverse: Gentleman–Sande, bit-reversed
input, natural output, with the final n^{-1} scaling fused as a Shoup
multiply.  Pointwise products in the transform domain realise negacyclic
(mod X^n + 1) convolution, which is what CKKS needs.

The stage loop is a Python loop over log2(n) statically-shaped reshapes, so
XLA sees a fixed DAG of fused element-wise passes, one per stage.

Replaces OpenFHE's NTT (used implicitly by every DCRTPoly op in
/root/reference; see SURVEY.md §3 "where the cycles actually go").
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from . import nt
from .rns import add_mod, sub_mod, shoup_mul


class NttContext:
    """Per-prime-chain twiddle tables, resident on device.

    Tables have shape [L, n] (limb-major) so transforms over a full RNS
    polynomial are a single batched pass.  A context built for primes
    [q0..qL-1] serves any prefix via slicing.
    """

    def __init__(self, primes: list[int], n: int):
        self.n = n
        self.logn = n.bit_length() - 1
        self.primes = list(primes)
        L = len(primes)
        psi = np.empty((L, n), dtype=np.uint32)
        psi_sh = np.empty((L, n), dtype=np.uint32)
        ipsi = np.empty((L, n), dtype=np.uint32)
        ipsi_sh = np.empty((L, n), dtype=np.uint32)
        n_inv = np.empty((L,), dtype=np.uint32)
        n_inv_sh = np.empty((L,), dtype=np.uint32)
        for i, p in enumerate(primes):
            tb = nt.make_ntt_tables(p, n)
            psi[i] = tb["psi_brv"]
            psi_sh[i] = tb["psi_brv_shoup"]
            ipsi[i] = tb["ipsi_brv"]
            ipsi_sh[i] = tb["ipsi_brv_shoup"]
            n_inv[i] = tb["n_inv"]
            n_inv_sh[i] = tb["n_inv_shoup"]
        self.p = jnp.asarray(np.asarray(primes, dtype=np.uint32))
        self.psi = jnp.asarray(psi)
        self.psi_sh = jnp.asarray(psi_sh)
        self.ipsi = jnp.asarray(ipsi)
        self.ipsi_sh = jnp.asarray(ipsi_sh)
        self.n_inv = jnp.asarray(n_inv)
        self.n_inv_sh = jnp.asarray(n_inv_sh)


def _bcast(w, extra_dims):
    """Reshape [L, m] table slice to broadcast against [..., L, m, (2,) t]."""
    return w.reshape(w.shape + (1,) * extra_dims)


def ntt_fwd_t(a: jnp.ndarray, p, psi, psi_sh) -> jnp.ndarray:
    """Forward negacyclic NTT with explicit tables (jit-friendly args).

    a: uint32 [..., L, n]; p: [L]; psi/psi_sh: [L, n].
    """
    L, n = a.shape[-2], a.shape[-1]
    lead = a.shape[:-2]
    pb = p.reshape((L, 1, 1))
    for s in range(n.bit_length() - 1):
        m = 1 << s
        t = n >> (s + 1)
        a = a.reshape(lead + (L, m, 2, t))
        w = _bcast(psi[:, m:2 * m], 1)
        w_sh = _bcast(psi_sh[:, m:2 * m], 1)
        u = a[..., 0, :]
        v = shoup_mul(a[..., 1, :], w, w_sh, pb)
        a = jnp.stack([add_mod(u, v, pb), sub_mod(u, v, pb)], axis=-2)
    return a.reshape(lead + (L, n))


def ntt_inv_t(a: jnp.ndarray, p, ipsi, ipsi_sh, n_inv, n_inv_sh) -> jnp.ndarray:
    """Inverse negacyclic NTT with explicit tables."""
    L, n = a.shape[-2], a.shape[-1]
    lead = a.shape[:-2]
    pb = p.reshape((L, 1, 1))
    for s in range(n.bit_length() - 1):
        h = n >> (s + 1)          # number of twiddle groups this stage
        t = n // (2 * h)          # butterfly width
        a = a.reshape(lead + (L, h, 2, t))
        w = _bcast(ipsi[:, h:2 * h], 1)
        w_sh = _bcast(ipsi_sh[:, h:2 * h], 1)
        u = a[..., 0, :]
        v = a[..., 1, :]
        lo = add_mod(u, v, pb)
        hi = shoup_mul(sub_mod(u, v, pb), w, w_sh, pb)
        a = jnp.stack([lo, hi], axis=-2)
    a = a.reshape(lead + (L, n))
    p2 = p.reshape((L, 1))
    return shoup_mul(a, n_inv.reshape((L, 1)), n_inv_sh.reshape((L, 1)), p2)


def ntt_fwd(a: jnp.ndarray, ctx: NttContext, limb_idx=None) -> jnp.ndarray:
    """Forward negacyclic NTT.

    a: uint32 [..., L, n] (coefficient domain, natural order).
    limb_idx: optional numpy index array selecting which table rows the L
        axis of `a` corresponds to (default: first L rows).
    Returns [..., L, n] in the transform domain (bit-reversed order).
    """
    L = a.shape[-2]
    sel = slice(0, L) if limb_idx is None else np.asarray(limb_idx)
    return ntt_fwd_t(a, ctx.p[sel], ctx.psi[sel], ctx.psi_sh[sel])


def ntt_inv(a: jnp.ndarray, ctx: NttContext, limb_idx=None) -> jnp.ndarray:
    """Inverse negacyclic NTT: [..., L, n] transform domain -> coefficients."""
    L = a.shape[-2]
    sel = slice(0, L) if limb_idx is None else np.asarray(limb_idx)
    return ntt_inv_t(a, ctx.p[sel], ctx.ipsi[sel], ctx.ipsi_sh[sel],
                     ctx.n_inv[sel], ctx.n_inv_sh[sel])


def negacyclic_convolve_reference(a: np.ndarray, b: np.ndarray, p: int) -> np.ndarray:
    """O(n^2) host-side negacyclic convolution oracle for tests."""
    n = len(a)
    out = np.zeros(n, dtype=object)
    aa = a.astype(object)
    bb = b.astype(object)
    for i in range(n):
        for j in range(n):
            k = i + j
            if k < n:
                out[k] = (out[k] + aa[i] * bb[j]) % p
            else:
                out[k - n] = (out[k - n] - aa[i] * bb[j]) % p
    return out.astype(np.uint64).astype(np.uint32)
