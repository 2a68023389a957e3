"""RNS-CKKS evaluator: the device-side homomorphic op surface.

Implements, in plain JAX, exactly the OpenFHE CryptoContext surface the
reference consumes (SURVEY.md L0): EvalAdd/Sub/Mult/Square (ct-ct, ct-pt,
ct-scalar) with FLEXIBLEAUTO-style lazy rescaling, EvalMultAndRelinearize,
EvalRotate via Galois automorphism + hybrid key switching, hoisted fast
rotations (EvalFastRotationPrecompute/EvalFastRotation), MakeCKKSPackedPlaintext
with SetSlots semantics, Encrypt/Decrypt (host client), level/scale tracking.

Representation: ciphertext components are uint32 [k, limbs, n] arrays in the
NTT (evaluation) domain and the Montgomery domain (see rns.py).  All base
conversion / rescale constants have the Montgomery factor folded in so data
never leaves the Montgomery domain.

Scale management: canonical per-limb-count scales S[l] anchored at
Delta = 2^scale_bits via adaptive prime selection (params.py); cts carry an
exact float64 scale; additions between mismatched operands are adjusted
exactly (integer scalar multiply + rescale), mirroring OpenFHE's
FLEXIBLEAUTO adjustment machinery.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, replace
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

try:                                   # trace-state probe (stackless JAX)
    from jax._src.core import trace_state_clean as _trace_state_clean
except ImportError:                    # pragma: no cover - API drift guard
    def _trace_state_clean() -> bool:
        return not isinstance(jnp.zeros(()) + 0, jax.core.Tracer)


def _concrete_ctx():
    """Context manager guarding cross-call cache fills: a no-op outside any
    trace (the common, per-op-jit driving mode), ensure_compile_time_eval
    when an OUTER jit is tracing (so cached device constants stay concrete
    instead of leaking tracers)."""
    from contextlib import nullcontext
    return nullcontext() if _trace_state_clean() \
        else jax.ensure_compile_time_eval()

from . import nt, encoding
from .params import CkksParams, CkksConfig, BASE_LIMBS
from .keys import KeyGenerator, Encryptor, Decryptor
from .rns import add_mod, sub_mod, mont_mul, shoup_mul, barrett_reduce_u32
from .ntt import ntt_fwd_t, ntt_inv_t

SCALE_TOL = 2.0 ** -25


@dataclass
class Ciphertext:
    """data: [k, rows, n] uint32, NTT+Montgomery domain, k in {2, 3}.

    With limb bucketing (CkksConfig.limb_pad > 1) the physical row count
    may exceed the LOGICAL limb count `limbs`: rows [limbs, rows) hold
    residues of some value ≡ the ciphertext mod Q_limbs (initially garbage
    left by a previous op).  Invariant: rows [0, limbs) are always the
    exact residues; every consumer that interprets the value (decrypt,
    mod_raise) slices to `limbs` first."""
    data: jnp.ndarray
    scale: float
    noise_deg: int      # 1: scale ~ S[l]; 2: product awaiting rescale
    slots: int
    limbs_: int | None = None   # logical limb count; None = data.shape[1]

    @property
    def limbs(self) -> int:
        return self.limbs_ if self.limbs_ is not None else self.data.shape[1]

    @property
    def k(self) -> int:
        return self.data.shape[0]

    def with_slots(self, s: int) -> "Ciphertext":
        """SetSlots: metadata-only reinterpretation (OpenFHE semantics)."""
        return replace(self, slots=s)


@dataclass
class Plaintext:
    data: jnp.ndarray   # [limbs, n] NTT+Montgomery
    scale: float
    slots: int

    @property
    def limbs(self) -> int:
        return self.data.shape[0]


def _shoup_host(w: int, p: int) -> tuple[int, int]:
    return w % p, ((w % p) << 32) // p


class _LevelTables:
    """Per-limb-count device constants for rescale / keyswitch / moddown.

    Registered as a JAX pytree (arrays = leaves, digit structure = static
    aux data) so whole-op kernels can be jitted with one compile per limb
    count.  The big [rows, n] twiddle tables are NOT sliced per level:
    every level shares the same full-chain device buffers and row
    selection happens inside the jitted op — at ring 2^17 per-level slices
    would pin several GB.
    """

    def __init__(self, P: CkksParams, l: int):
        q = P.q
        n = P.n
        nq = P.nq
        ksp = P.num_special
        sp = P.p_special
        ntt = P.ntt
        self.l = l
        self.nq = nq
        self.ksp = ksp
        self.comp = P.comp

        # --- small per-row prime vectors (q / ext / special row sets) ---
        sprows = np.arange(nq, nq + ksp)
        ext_rows = np.concatenate([np.arange(l), sprows])
        self.q_p = ntt.p[:l]
        self.ext_p = ntt.p[ext_rows]
        self.sp_p = ntt.p[sprows]

        # --- NTT tables: references to the shared NttContext buffers ---
        self.t_psi = ntt.psi
        self.t_psi_sh = ntt.psi_sh
        self.t_ipsi = ntt.ipsi
        self.t_ipsi_sh = ntt.ipsi_sh
        self.t_ninv = ntt.n_inv
        self.t_ninv_sh = ntt.n_inv_sh
        self.t_p = ntt.p

        # --- rescale row constants (dropped-prime-independent): Barrett
        #     factors and to-Montgomery pairs for every q row of the bucket.
        #     The dropped-prime-dependent constants live in the per-logical-l
        #     _RescaleConsts pytree so one compiled rescale kernel serves
        #     every limb count in the bucket. ---
        self.pbar = jnp.asarray(np.array(
            [(1 << 32) // p for p in q[:l]], dtype=np.uint32))
        rmod_all = [(1 << 32) % p for p in q[:l]]
        self.rmod = jnp.asarray(np.array(rmod_all, dtype=np.uint32))
        self.rmod_sh = jnp.asarray(np.array(
            [(r << 32) // p for r, p in zip(rmod_all, q[:l])],
            dtype=np.uint32))

        # --- keyswitch digit tables ---
        alpha = P.alpha
        ndig = -(-l // alpha)
        self.ndig = ndig
        self.digits = [list(range(j * alpha, min((j + 1) * alpha, l)))
                       for j in range(ndig)]
        ext_primes = [q[i] for i in range(l)] + list(sp)
        self.ext_primes = ext_primes
        R = 1 << 32
        self.dig_in = []      # (w, w_sh) [dj] plain-producing constants
        self.dig_conv = []    # (C_w, C_sh) [dj, l+ksp]
        for dig in self.digits:
            D = 1
            for i in dig:
                D *= q[i]
            w_in = []
            wsh_in = []
            Cw = np.zeros((len(dig), len(ext_primes)), dtype=np.uint32)
            Csh = np.zeros_like(Cw)
            for a, i in enumerate(dig):
                d = q[i]
                dh = D // d
                # fold R^{-1}: Mont input -> plain [x * (D/d)^{-1}]_d
                c = nt.mod_inverse(dh % d, d) * nt.mod_inverse(R % d, d) % d
                w_in.append(c)
                wsh_in.append((c << 32) // d)
                for r, pr in enumerate(ext_primes):
                    # fold R: plain xhat -> Mont output
                    cc = (dh % pr) * (R % pr) % pr
                    Cw[a, r] = cc
                    Csh[a, r] = (cc << 32) // pr
            self.dig_in.append((
                jnp.asarray(np.array(w_in, dtype=np.uint32)),
                jnp.asarray(np.array(wsh_in, dtype=np.uint32))))
            self.dig_conv.append((jnp.asarray(Cw), jnp.asarray(Csh)))

        # --- moddown tables (basis P -> q rows) ---
        Pint = P.P_int
        w_in = []
        wsh_in = []
        Cw = np.zeros((ksp, l), dtype=np.uint32)
        Csh = np.zeros_like(Cw)
        for a, p in enumerate(sp):
            ph = Pint // p
            c = nt.mod_inverse(ph % p, p) * nt.mod_inverse(R % p, p) % p
            w_in.append(c)
            wsh_in.append((c << 32) // p)
            for r in range(l):
                qr = q[r]
                cc = (ph % qr) * (R % qr) % qr
                Cw[a, r] = cc
                Csh[a, r] = (cc << 32) // qr
        self.md_in = (jnp.asarray(np.array(w_in, dtype=np.uint32)),
                      jnp.asarray(np.array(wsh_in, dtype=np.uint32)))
        self.md_conv = (jnp.asarray(Cw), jnp.asarray(Csh))
        pinv = [nt.mod_inverse(Pint % q[r], q[r]) for r in range(l)]
        self.md_pinv = jnp.asarray(np.array(pinv, dtype=np.uint32))
        self.md_pinv_sh = jnp.asarray(np.array(
            [(v << 32) // q[r] for r, v in enumerate(pinv)], dtype=np.uint32))
        # approximate-extension magnitude correction is omitted (HPS-style
        # approximate conversion; error < ksp per coefficient, absorbed by
        # CKKS noise) — same design as OpenFHE ApproxSwitchCRTBasis.

    # ---- pytree protocol: arrays traced, structure static ----
    _STATIC = ("l", "ndig", "digits", "ext_primes", "nq", "ksp", "comp")

    def tree_flatten(self):
        keys = tuple(sorted(k for k in self.__dict__ if k not in self._STATIC))
        children = [self.__dict__[k] for k in keys]
        aux = (keys, tuple((k, _freeze(self.__dict__[k]))
                           for k in self._STATIC if k in self.__dict__))
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls.__new__(cls)
        keys, static = aux
        for k, v in static:
            obj.__dict__[k] = _unfreeze(v)
        for k, v in zip(keys, children):
            obj.__dict__[k] = v
        return obj


def _freeze(v):
    return tuple(_freeze(x) for x in v) if isinstance(v, list) else v


def _unfreeze(v):
    return [_unfreeze(x) for x in v] if isinstance(v, tuple) else v


jax.tree_util.register_pytree_node(
    _LevelTables,
    lambda t: t.tree_flatten(),
    _LevelTables.tree_unflatten)


# ===================== device kernels (pure functions) =====================
#
# NTT row sets: every kernel below reaches the transform through these
# helpers.  'q' = chain prefix [0, k), 'ext' = q rows of the level plus the
# special primes, 'sp' = special primes only.


def _fwd_q(x, T: "_LevelTables", k: int):
    return ntt_fwd_t(x, T.t_p[:k], T.t_psi[:k], T.t_psi_sh[:k])


def _inv_q(x, T: "_LevelTables", lo: int, hi: int):
    return ntt_inv_t(x, T.t_p[lo:hi], T.t_ipsi[lo:hi], T.t_ipsi_sh[lo:hi],
                     T.t_ninv[lo:hi], T.t_ninv_sh[lo:hi])


def _fwd_ext(x, T: "_LevelTables"):
    l, nq, ksp = T.l, T.nq, T.ksp
    cat = lambda t: jnp.concatenate([t[:l], t[nq:nq + ksp]], axis=0)
    return ntt_fwd_t(x, cat(T.t_p), cat(T.t_psi), cat(T.t_psi_sh))


def _inv_sp(x, T: "_LevelTables"):
    nq, ksp = T.nq, T.ksp
    s = slice(nq, nq + ksp)
    return ntt_inv_t(x, T.t_p[s], T.t_ipsi[s], T.t_ipsi_sh[s],
                     T.t_ninv[s], T.t_ninv_sh[s])


def _k_add(a, b, p):
    return add_mod(a, b, p)


def _k_sub(a, b, p):
    return sub_mod(a, b, p)


def _k_mult3(a, b, p, npi):
    """(a0,a1) x (b0,b1) -> (d0,d1,d2) tensor product."""
    pb = p.reshape(1, -1, 1)
    nb = npi.reshape(1, -1, 1)
    d0 = mont_mul(a[0:1], b[0:1], pb, nb)
    d2 = mont_mul(a[1:2], b[1:2], pb, nb)
    d1 = add_mod(mont_mul(a[0:1], b[1:2], pb, nb),
                 mont_mul(a[1:2], b[0:1], pb, nb), pb)
    return jnp.concatenate([d0, d1, d2], axis=0)


def _k_square3(a, p, npi):
    pb = p.reshape(1, -1, 1)
    nb = npi.reshape(1, -1, 1)
    d0 = mont_mul(a[0:1], a[0:1], pb, nb)
    d2 = mont_mul(a[1:2], a[1:2], pb, nb)
    x = mont_mul(a[0:1], a[1:2], pb, nb)
    d1 = add_mod(x, x, pb)
    return jnp.concatenate([d0, d1, d2], axis=0)


def _k_pt_mul(a, pt, p, npi):
    pb = p.reshape(1, -1, 1)
    nb = npi.reshape(1, -1, 1)
    return mont_mul(a, pt[None], pb, nb)


def _k_const_mul(a, w, w_sh, p):
    """Multiply by per-limb plain constants (shape [l])."""
    pb = p.reshape(1, -1, 1)
    return shoup_mul(a, w.reshape(1, -1, 1), w_sh.reshape(1, -1, 1), pb)


def _inv_q_dyn(x, T: "_LevelTables", idx):
    """Inverse NTT of a single q row whose chain index `idx` is a traced
    scalar (the rescale kernel's dropped-prime row varies per logical limb
    count within one compiled bucket shape)."""
    take = lambda t: jax.lax.dynamic_slice_in_dim(t, idx, 1, axis=0)
    return ntt_inv_t(x, take(T.t_p), take(T.t_ipsi), take(T.t_ipsi_sh),
                     take(T.t_ninv), take(T.t_ninv_sh))


def _k_rescale(data, steps, T: _LevelTables):
    """Composite rescale: drop the `comp` primes q[l-1], q[l-2], ... in one
    fused op.  Per dropped prime q_d: (c - lift([c]_{q_d})) * q_d^{-1}
    (OpenFHE ModReduce semantics, one level = comp primes).

    `steps` carries the dropped-prime-dependent constants as traced leaves
    (see CkksContext._rescale_consts) so the kernel compiles once per
    BUCKET row count, not once per logical limb count.  Rows at and above
    the dropped prime end up garbage — consistent with the bucketing
    invariant (the logical limb count drops by comp)."""
    rows = data.shape[1]
    p_all = T.q_p.reshape(1, -1, 1)
    for i in range(T.comp):
        (idx, rinv, rinv_sh, qd, half, qd_mod, qdinv, qdinv_sh) = steps[i]
        last = jax.lax.dynamic_slice_in_dim(data, idx, 1, axis=1)
        lc = _inv_q_dyn(last, T, idx)                # [k,1,n] Mont coeff
        v = shoup_mul(lc, rinv, rinv_sh, qd)         # plain [k,1,n]
        big = v > half
        r = barrett_reduce_u32(v, p_all, T.pbar.reshape(1, -1, 1))
        r = jnp.where(big, sub_mod(r, qd_mod.reshape(1, -1, 1), p_all), r)
        rm = shoup_mul(r, T.rmod.reshape(1, -1, 1),
                       T.rmod_sh.reshape(1, -1, 1), p_all)   # to Mont
        rn = _fwd_q(rm, T, rows)
        diff = sub_mod(data, rn, p_all)
        data = shoup_mul(diff, qdinv.reshape(1, -1, 1),
                         qdinv_sh.reshape(1, -1, 1), p_all)
    return data


def _k_decompose(cx, T: _LevelTables):
    """Hybrid-keyswitch digit decomposition of one poly [l, n] (NTT Mont).

    Returns ext digits stacked [ndig, l+ksp, n] in NTT+Mont domain
    (EvalFastRotationPrecompute equivalent)."""
    l = cx.shape[0]
    cc = _inv_q(cx, T, 0, l)
    accs = []
    for j, dig in enumerate(T.digits):
        x = cc[dig[0]: dig[-1] + 1]                  # [dj, n] Mont coeff
        w, wsh = T.dig_in[j]
        dp = T.q_p[dig[0]: dig[-1] + 1]
        xhat = shoup_mul(x, w.reshape(-1, 1), wsh.reshape(-1, 1),
                         dp.reshape(-1, 1))          # plain [dj, n]
        Cw, Csh = T.dig_conv[j]
        pe = T.ext_p.reshape(-1, 1)
        acc = None
        for a in range(len(dig)):
            term = shoup_mul(xhat[a][None, :], Cw[a].reshape(-1, 1),
                             Csh[a].reshape(-1, 1), pe)   # [l+ksp, n] Mont
            acc = term if acc is None else add_mod(acc, term, pe)
        # exact copies for in-digit rows (consistent: offset ≡ 0 mod them)
        acc = acc.at[dig[0]: dig[-1] + 1].set(x)
        accs.append(acc)
    # one batched forward NTT over all digits' extended bases
    return _fwd_ext(jnp.stack(accs), T)


def _k_ks_inner(exts, ksk, T: _LevelTables):
    """Inner product of ext digits with key: returns [2, l+ksp, n]."""
    pe = T.ext_p.reshape(1, -1, 1)
    # ksk: [>=ndig, 2, nq+ksp, n]; rows already selected by caller
    acc = None
    for j in range(exts.shape[0]):
        from .rns import mont_mul as mm
        npi = T.ext_npi.reshape(1, -1, 1)
        term = mm(exts[j][None], ksk[j], pe, npi)     # [2, l+ksp, n]
        acc = term if acc is None else add_mod(acc, term, pe)
    return acc


def _k_moddown(acc, T: _LevelTables):
    """[k, l+ksp, n] NTT Mont -> [k, l, n]: (x - lift([x]_P)) * P^{-1}."""
    l = T.l
    spv = acc[:, l:, :]
    spc = _inv_sp(spv, T)                             # [k, ksp, n] Mont coeff
    w, wsh = T.md_in
    xhat = shoup_mul(spc, w.reshape(1, -1, 1), wsh.reshape(1, -1, 1),
                     T.sp_p.reshape(1, -1, 1))        # plain
    Cw, Csh = T.md_conv
    qp = T.q_p.reshape(1, -1, 1)
    conv = None
    for a in range(spc.shape[1]):
        term = shoup_mul(xhat[:, a:a + 1, :], Cw[a].reshape(1, -1, 1),
                         Csh[a].reshape(1, -1, 1), qp)  # [k, l, n] Mont
        conv = term if conv is None else add_mod(conv, term, qp)
    convn = _fwd_q(conv, T, l)
    diff = sub_mod(acc[:, :l, :], convn, qp)
    return shoup_mul(diff, T.md_pinv.reshape(1, -1, 1),
                     T.md_pinv_sh.reshape(1, -1, 1), qp)


def _k_automorph(data, perm):
    return data[..., perm]


# ============ jitted super-kernels: one compile per limb count ============


def _sel_rows(ksk, T: _LevelTables):
    rows = np.concatenate([np.arange(T.l), np.arange(T.nq, T.nq + T.ksp)])
    return ksk[: T.ndig][:, :, rows, :]


@jax.jit
def _kj_rescale(data, steps, T):
    return _k_rescale(data, steps, T)


@jax.jit
def _kj_mult_relin(a, b, ksk, T):
    d = _k_mult3(a, b, T.q_p, T.q_npi)
    exts = _k_decompose(d[2], T)
    acc = _k_ks_inner(exts, _sel_rows(ksk, T), T)
    dd = _k_moddown(acc, T)
    p = T.q_p.reshape(1, -1, 1)
    return add_mod(d[:2], dd, p)


@jax.jit
def _kj_square_relin(a, ksk, T):
    d = _k_square3(a, T.q_p, T.q_npi)
    exts = _k_decompose(d[2], T)
    acc = _k_ks_inner(exts, _sel_rows(ksk, T), T)
    dd = _k_moddown(acc, T)
    p = T.q_p.reshape(1, -1, 1)
    return add_mod(d[:2], dd, p)


@jax.jit
def _kj_relin3(data, ksk, T):
    exts = _k_decompose(data[2], T)
    acc = _k_ks_inner(exts, _sel_rows(ksk, T), T)
    dd = _k_moddown(acc, T)
    p = T.q_p.reshape(1, -1, 1)
    return add_mod(data[:2], dd, p)


@jax.jit
def _kj_decompose(c1, T):
    return _k_decompose(c1, T)


@jax.jit
def _kj_rotate_fused(data, ksk, perm, T):
    """Single-dispatch EvalRotate: decompose + automorphism + key inner
    product + moddown in ONE fused kernel.  Used for one-shot rotations
    (no precompute sharing); saves a dispatch and the HBM round trip of
    the [ndig, l+ksp, n] digit tensor vs decompose-then-fast-rotate."""
    exts = _k_automorph(_k_decompose(data[1], T), perm)
    acc = _k_ks_inner(exts, _sel_rows(ksk, T), T)
    d = _k_moddown(acc, T)
    p = T.q_p.reshape(1, -1, 1)
    c0 = add_mod(_k_automorph(data[0:1], perm), d[0:1], p)
    return jnp.concatenate([c0, d[1:2]], axis=0)


@jax.jit
def _kj_fast_rotate(data, precomp, ksk, perm, T):
    exts = _k_automorph(precomp, perm)
    acc = _k_ks_inner(exts, _sel_rows(ksk, T), T)
    d = _k_moddown(acc, T)
    p = T.q_p.reshape(1, -1, 1)
    c0 = add_mod(_k_automorph(data[0:1], perm), d[0:1], p)
    return jnp.concatenate([c0, d[1:2]], axis=0)


@jax.jit
def _kj_mod_raise(data, w, wsh, Cw, Csh, dinv_f, DmodR, DmodR_sh,
                  T_lo, T_hi):
    """ModRaise kernel: [k, l0, n] NTT+Mont at modulus D = prod(q[:l0]) ->
    [k, nq, n] at the full chain, with centered lift.

    CRT extension with a float32 correction count: the plain digit values
    xhat_i determine u = round(sum xhat_i / d_i); subtracting u*D centers
    the lift in (-D/2, D/2).  A float32 misround shifts one coefficient by
    +-D — an integer multiple of D, absorbed by EvalMod's periodic sine
    (core/bootstrap.py)."""
    l0 = data.shape[1]
    x = _inv_q(data, T_lo, 0, l0)                    # [k, l0, n] Mont coeff
    dp = T_lo.q_p[:l0].reshape(1, -1, 1)
    xhat = shoup_mul(x, w.reshape(1, -1, 1), wsh.reshape(1, -1, 1), dp)
    y = jnp.sum(xhat.astype(jnp.float32) * dinv_f.reshape(1, -1, 1), axis=1)
    corr = jnp.round(y).astype(jnp.uint32)           # [k, n], <= l0
    qp = T_hi.q_p.reshape(1, -1, 1)
    acc = None
    for i in range(l0):
        term = shoup_mul(xhat[:, i:i + 1, :], Cw[i].reshape(1, -1, 1),
                         Csh[i].reshape(1, -1, 1), qp)
        acc = term if acc is None else add_mod(acc, term, qp)
    corr_term = shoup_mul(corr[:, None, :], DmodR.reshape(1, -1, 1),
                          DmodR_sh.reshape(1, -1, 1), qp)
    acc = sub_mod(acc, corr_term, qp)
    acc = acc.at[:, :l0, :].set(x)                   # in-digit rows exact
    return _fwd_q(acc, T_hi, acc.shape[1])


@jax.jit
def _kj_encode(rows, rmod, rmod_sh, T):
    """Plain uint32 coefficient rows [l, n] -> NTT+Montgomery domain."""
    l = rows.shape[0]
    dev = shoup_mul(rows, rmod.reshape(-1, 1), rmod_sh.reshape(-1, 1),
                    T.q_p.reshape(-1, 1))
    return _fwd_q(dev, T, l)


_kj_add = jax.jit(_k_add)
_kj_sub = jax.jit(_k_sub)
_kj_pt_mul = jax.jit(_k_pt_mul)
_kj_const_mul = jax.jit(_k_const_mul)
_kj_permute = jax.jit(_k_automorph)


@jax.jit
def _kj_negate(data, p):
    return jnp.where(data == 0, data, p - data)


# ===================== context =====================


class CkksContext:
    """CryptoContext equivalent: params + keys + evaluator + client ops."""

    def __init__(self, cfg: CkksConfig):
        self._init_common(cfg)
        P = self.params
        self.keygen = KeyGenerator(P)
        self.encryptor = Encryptor(P, self.keygen.public_key)
        self.decryptor = Decryptor(P, self.keygen.sk)
        self.relin_key = jnp.asarray(self.keygen.gen_relin_key())

    def _init_common(self, cfg: CkksConfig):
        self.cfg = cfg
        self.params = CkksParams(cfg)
        self.n = self.params.n
        self.delta = float(2 ** cfg.scale_bits)
        from .keystore import KeyStore
        import os as _os_
        budget_mb = cfg.rot_key_budget_mb
        if budget_mb is None:
            env = _os_.environ.get("SORTING_FHE_KEY_BUDGET_MB")
            budget_mb = int(env) if env else None
        self._key_streaming = budget_mb is not None
        self.rot_keys: "KeyStore" = KeyStore(
            (budget_mb << 20) if budget_mb else None,
            regen=self._regen_rot_key)
        self._tables: dict[int, _LevelTables] = {}
        self._rs_cache: dict[int, tuple] = {}
        self._perm_cache: dict[int, jnp.ndarray] = {}
        # plaintext cache: byte-capped LRU.  A full-fidelity N=128 sort
        # encodes hundreds of [~95, 2^17] u32 mask plaintexts (~50 MB
        # each), so an unbounded cache grows with the sort and competes
        # with the keyswitch keys for device memory.  Masks re-encode from
        # the host row cache, so eviction costs little; the cap keeps hot
        # reuse (BSGS diagonals, per-trial mask reuse) effective.
        import collections
        import os as _os
        self._pt_cache: "collections.OrderedDict" = collections.OrderedDict()
        self._pt_cache_bytes = 0
        self._pt_cache_cap = int(_os.environ.get(
            "SORTING_FHE_PT_CACHE_MB", "3072")) << 20
        self.mult_count = 0
        self.rot_count = 0
        self.precompute_count = 0   # hoisting decompositions (c1 digit
        #                             expansions); drops when RotationTree
        #                             shares them across rotations
        self.pt_encode_s = 0.0      # wall spent encoding plaintexts
        self.pt_encode_count = 0    # (host iFFT + RNS rows + device NTT)
        import collections as _coll
        self.op_counts = _coll.Counter()   # per-kernel dispatch census
        #   (SURVEY §5.1 op-counter parity; drives the bench's
        #    time-attribution table)

    @classmethod
    def for_evaluation(cls, cfg: CkksConfig, public_key, relin_key,
                       rot_keys: dict, conj_key=None) -> "CkksContext":
        """Blind-evaluation (server-side) context: public material only,
        no secret key.  The analogue of the reference's deserialized
        CryptoContext (/root/reference/src/sort.h:31-74): the server can
        encrypt, evaluate, and serialize — decrypt() raises."""
        self = cls.__new__(cls)
        self._init_common(cfg)
        self.keygen = None
        self.encryptor = Encryptor(self.params, tuple(public_key))
        self.decryptor = None
        self.relin_key = jnp.asarray(relin_key)
        self.rot_keys = {int(k): jnp.asarray(v) for k, v in rot_keys.items()}
        if conj_key is not None:
            self.conj_key = jnp.asarray(conj_key)
        return self

    # ---------------- tables ----------------
    def bucket_limbs(self, l: int) -> int:
        """Physical row count for logical limb count l: next multiple of
        cfg.limb_pad, clamped to the chain length.  Collapses the ~L
        distinct per-limb-count kernel compiles of a deep chain to
        ~L/limb_pad (about 46 limb counts x ~8 kernels at depth 46)."""
        B = self.cfg.limb_pad
        if B <= 1:
            return l
        return min(self.params.nq, -(-l // B) * B)

    def tables(self, l: int) -> _LevelTables:
        """Level tables for the BUCKET containing logical limb count l."""
        l = self.bucket_limbs(l)
        if l not in self._tables:
            self._tables[l] = self._build_tables(l)
        return self._tables[l]

    def tables_exact(self, l: int) -> _LevelTables:
        """Un-bucketed tables for consumers that interpret the value at
        exactly l limbs (mod_raise's CRT lift)."""
        if self.cfg.limb_pad <= 1 or l == self.bucket_limbs(l):
            return self.tables(l)
        if not hasattr(self, "_tables_exact_cache"):
            self._tables_exact_cache = {}
        if l not in self._tables_exact_cache:
            self._tables_exact_cache[l] = self._build_tables(l)
        return self._tables_exact_cache[l]

    def _build_tables(self, l: int) -> _LevelTables:
        # ensure_compile_time_eval: tables may be built lazily while an
        # OUTER jit is tracing (e.g. a whole sort step under one jit);
        # without it the constants would be created as tracers and leak
        # into this cross-call cache.
        with _concrete_ctx():
            T = _LevelTables(self.params, l)
            npi_rows = np.concatenate([
                np.arange(l),
                np.arange(self.params.nq,
                          self.params.nq + self.params.num_special)])
            T.ext_npi = self.params.mont_neg_p_inv[npi_rows]
            T.q_npi = self.params.mont_neg_p_inv[:l]
        return T

    def canonical_scale(self, l: int) -> float:
        return self.params.canonical_scale[l]

    # ---------------- plaintext-cache LRU plumbing ----------------
    def _pt_get(self, key):
        hit = self._pt_cache.get(key)
        if hit is None:
            return None
        self._pt_cache.move_to_end(key)
        return hit[0]

    def _pt_put(self, key, value, nbytes: int):
        if key in self._pt_cache:
            self._pt_cache_bytes -= self._pt_cache[key][1]
        self._pt_cache[key] = (value, nbytes)
        self._pt_cache_bytes += nbytes
        while (self._pt_cache_bytes > self._pt_cache_cap
               and len(self._pt_cache) > 1):
            _, (_, ob) = self._pt_cache.popitem(last=False)
            self._pt_cache_bytes -= ob
        return value

    def _rescale_consts(self, l: int) -> tuple:
        """Dropped-prime-dependent rescale constants for LOGICAL limb count
        l, shaped for the bucket (leaves of the _kj_rescale pytree arg, so
        any l in a bucket reuses one compiled kernel)."""
        if l in self._rs_cache:
            return self._rs_cache[l]
        P = self.params
        rows = self.bucket_limbs(l)
        q = P.q
        with _concrete_ctx():
            steps = []
            for i in range(P.comp):
                cur = l - i                  # limb count before this drop
                qd = q[cur - 1]
                rinv = nt.mod_inverse((1 << 32) % qd, qd)
                qd_mod = np.zeros(rows, dtype=np.uint32)
                qdinv = np.zeros(rows, dtype=np.uint32)
                qdinv_sh = np.zeros(rows, dtype=np.uint32)
                for r in range(rows):
                    p = q[r]
                    if p == qd:              # dropped row: output is garbage
                        continue
                    qd_mod[r] = qd % p
                    v = nt.mod_inverse(qd % p, p)
                    qdinv[r] = v
                    qdinv_sh[r] = (v << 32) // p
                steps.append((
                    jnp.asarray(np.int32(cur - 1)),
                    jnp.uint32(rinv),
                    jnp.uint32((rinv << 32) // qd),
                    jnp.uint32(qd),
                    jnp.uint32(qd // 2),
                    jnp.asarray(qd_mod),
                    jnp.asarray(qdinv),
                    jnp.asarray(qdinv_sh),
                ))
        self._rs_cache[l] = tuple(steps)
        return self._rs_cache[l]

    # ---------------- key management ----------------
    def gen_rotation_keys(self, indices: list[int]):
        """EvalRotateKeyGen equivalent.  Under a rotation-key budget
        (cfg.rot_key_budget_mb / SORTING_FHE_KEY_BUDGET_MB) keys are only
        REGISTERED here; they materialize on first use through the
        KeyStore's deterministic device-side regeneration and live in a
        byte-capped LRU (core/keystore.py)."""
        half = self.n // 2
        for k in indices:
            kk = k % half
            if kk and kk not in self.rot_keys:
                if self.keygen is None:
                    raise KeyError(
                        f"evaluation-only context is missing rotation key "
                        f"{k}: regenerate and reserialize with it")
                if self._key_streaming:
                    self.rot_keys.register(kk)
                    continue
                g = encoding.galois_element_for_rotation(self.n, kk)
                with _concrete_ctx():
                    self.rot_keys[kk] = jnp.asarray(
                        self.keygen.gen_rotation_key(g))

    def _regen_rot_key(self, kk: int):
        """KeyStore regen hook: deterministic device-side Galois keygen."""
        g = encoding.galois_element_for_rotation(self.n, kk)
        with _concrete_ctx():
            return self.keygen.gen_rotation_key_dev(g)

    def _perm(self, k: int) -> jnp.ndarray:
        if k not in self._perm_cache:
            g = encoding.galois_element_for_rotation(self.n, k)
            with _concrete_ctx():
                self._perm_cache[k] = jnp.asarray(
                    encoding.automorphism_eval_perm(self.n, g).astype(
                        np.int32))
        return self._perm_cache[k]

    # ---------------- client ops (host) ----------------
    def encrypt(self, values, slots: int | None = None) -> Ciphertext:
        slots = slots or self.params.num_slots
        coeffs = encoding.encode_real(np.asarray(values, dtype=np.float64),
                                      self.n, self.delta, slots)
        data = self.encryptor.encrypt_coeffs(coeffs)
        return Ciphertext(jnp.asarray(data), self.delta, 1, slots)

    def decrypt(self, ct: Ciphertext, complex_out: bool = False) -> np.ndarray:
        if self.decryptor is None:
            raise RuntimeError("evaluation-only context has no secret key")
        # enough limbs that prod(q) > value * scale * 2^20 headroom
        bits_needed = np.log2(max(ct.scale, 1.0)) + 24
        need = 0
        acc = 0.0
        while acc < bits_needed and need < ct.limbs:
            acc += np.log2(float(self.params.q[need]))
            need += 1
        need = min(ct.limbs, need)
        # slice on device: only the limbs decryption uses cross the
        # device->host link (full towers are ~100 MB at ring 2^17)
        data = np.asarray(ct.data[:, :need, :])
        coeffs = self.decryptor.decrypt_to_coeffs(
            data, need, max_limbs=need)
        return encoding.decode_real(coeffs.astype(np.float64), self.n,
                                    ct.scale, ct.slots,
                                    complex_out=complex_out)

    def zero_like(self, ct: Ciphertext) -> Ciphertext:
        return Ciphertext(jnp.zeros_like(ct.data), ct.scale, ct.noise_deg,
                          ct.slots, limbs_=ct.limbs)

    def fresh_zero(self, slots: int | None = None) -> Ciphertext:
        slots = slots or self.params.num_slots
        z = jnp.zeros((2, self.params.nq, self.n), dtype=jnp.uint32)
        return Ciphertext(z, self.delta, 1, slots)

    # ---------------- plaintext encoding ----------------
    def make_plaintext(self, values, limbs: int, scale: float,
                       slots: int | None = None) -> Plaintext:
        """MakeCKKSPackedPlaintext equivalent (NTT+Mont, device)."""
        slots = slots or self.params.num_slots
        v = np.asarray(values)
        if not np.iscomplexobj(v):
            v = v.astype(np.float64)
        # encode at the bucket row count so one cached plaintext covers
        # every ciphertext in the bucket (plaintext rows are all valid
        # residues, so any prefix slice stays exact)
        limbs = self.bucket_limbs(limbs)
        key = (hashlib.md5(v.tobytes()).hexdigest(), str(v.dtype), limbs,
               float(scale), slots)
        hit = self._pt_get(key)
        if hit is not None:
            return hit
        import time as _time
        t0 = _time.time()
        # two-level cache: device plaintexts are HBM-capped (LRU above),
        # but the HOST coefficient rows are cheap RAM — on device eviction
        # only the transfer + device NTT re-runs, not the host iFFT +
        # per-limb reduction, which an N=128 sort would otherwise repeat
        # for ~130 masks every trial
        if not hasattr(self, "_pt_host_cache"):
            import collections
            self._pt_host_cache = collections.OrderedDict()
            self._pt_host_bytes = 0
            import os as _os
            self._pt_host_cap = int(_os.environ.get(
                "SORTING_FHE_PT_HOST_CACHE_MB", "16384")) << 20
        rows = self._pt_host_cache.get(key)
        if rows is None:
            coeffs = encoding.encode_real(v, self.n, scale, slots)
            rows = np.empty((limbs, self.n), dtype=np.uint32)
            for i in range(limbs):
                p = self.params.q[i]
                r = np.fmod(coeffs, float(p))
                rows[i] = np.where(r < 0, r + p, r).astype(np.uint32)
            self._pt_host_cache[key] = rows
            self._pt_host_bytes += rows.nbytes
            while (self._pt_host_bytes > self._pt_host_cap
                   and len(self._pt_host_cache) > 1):
                _, old = self._pt_host_cache.popitem(last=False)
                self._pt_host_bytes -= old.nbytes
        else:
            self._pt_host_cache.move_to_end(key)
        pt = Plaintext(self._to_eval_domain(rows, limbs), float(scale), slots)
        self.pt_encode_s += _time.time() - t0
        self.pt_encode_count += 1
        return self._pt_put(key, pt, limbs * self.n * 4)

    def _to_eval_domain(self, rows: np.ndarray, limbs: int) -> jnp.ndarray:
        """Host plain-coefficient rows [limbs, n] -> concrete device array
        in the NTT+Montgomery domain.

        Called from the cross-call plaintext cache, so the result must be
        CONCRETE even when an outer jit is tracing.  Outside any trace the
        jitted encode kernel runs directly; under an outer trace the same
        arithmetic runs inside jax.ensure_compile_time_eval."""
        rmod = np.array([(1 << 32) % self.params.q[i]
                         for i in range(limbs)], dtype=np.uint32)
        rsh = np.array([(int(r) << 32) // self.params.q[i]
                        for i, r in enumerate(rmod)], dtype=np.uint32)
        if _trace_state_clean():
            T = self.tables(limbs)
            return _kj_encode(jnp.asarray(rows), jnp.asarray(rmod),
                              jnp.asarray(rsh), T)
        with jax.ensure_compile_time_eval():
            T = self.tables(limbs)
            dev = shoup_mul(jnp.asarray(rows), jnp.asarray(rmod).reshape(-1, 1),
                            jnp.asarray(rsh).reshape(-1, 1),
                            T.q_p.reshape(-1, 1))
            return _fwd_q(dev, T, limbs)

    def _scalar_limb_consts(self, m: int, limbs: int):
        """Integer scalar (possibly negative) as per-limb plain constants."""
        ws = []
        shs = []
        for i in range(limbs):
            p = self.params.q[i]
            w = m % p
            ws.append(w)
            shs.append((w << 32) // p)
        return (jnp.asarray(np.array(ws, dtype=np.uint32)),
                jnp.asarray(np.array(shs, dtype=np.uint32)))

    # ---------------- rescale / level management ----------------
    def rescale(self, ct: Ciphertext) -> Ciphertext:
        """Composite rescale: drop `comp` primes (one level, one kernel)."""
        comp = self.params.comp
        l = ct.limbs
        assert l - comp >= self.params.base_limbs, \
            "cannot rescale below base limbs"
        T = self.tables(l)
        dropped = 1.0
        for i in range(comp):
            dropped *= float(self.params.q[l - 1 - i])
        self.op_counts["rescale"] += 1
        data = _kj_rescale(ct.data, self._rescale_consts(l), T)
        tb = self.bucket_limbs(l - comp)
        if tb < data.shape[1]:
            data = data[:, :tb, :]
        return Ciphertext(data, ct.scale / dropped, 1, ct.slots,
                          limbs_=l - comp)

    def level_reduce(self, ct: Ciphertext, target_limbs: int) -> Ciphertext:
        assert target_limbs <= ct.limbs
        if target_limbs == ct.limbs:
            return ct
        tb = self.bucket_limbs(target_limbs)
        data = ct.data[:, :tb, :] if tb < ct.data.shape[1] else ct.data
        return replace(ct, data=data, limbs_=target_limbs)

    def _ensure_deg1(self, ct: Ciphertext) -> Ciphertext:
        return self.rescale(ct) if ct.noise_deg == 2 else ct

    def _anchor(self, ct: Ciphertext) -> Ciphertext:
        """Bound FLEXIBLEAUTO scale drift before multiplications.

        Squaring DOUBLES the log-deviation of the exact scale from the
        canonical ladder each step, so any seed drift (bootstrap output
        lands ~1% off; plaintext mults at Delta != S[l] add more) grows
        double-exponentially through long sign chains — bitonic's
        repeated bootstrap->sign cycles ran scales to inf/0 without it.  When a deg-1 ct deviates by more than sqrt(2), spend one
        level to land back on canonical — the OpenFHE adjust-scale
        analogue.  Normal sort flows stay within ~5% and never trigger."""
        if ct.noise_deg != 1 or \
                ct.limbs - self.params.comp < self.params.base_limbs:
            return ct
        r = ct.scale / self.canonical_scale(ct.limbs)
        if 0.7071 < r < 1.4142:
            return ct
        t = ct.limbs - self.params.comp
        return self.adjust_to(ct, t, self.canonical_scale(t))

    def adjust_to(self, ct: Ciphertext, target_limbs: int,
                  target_scale: float) -> Ciphertext:
        """Bring ct to (target_limbs, ~target_scale) exactly: drop limbs,
        then integer-scalar multiply + one rescale to land on the scale."""
        ct = self._ensure_deg1(ct)
        if ct.limbs == target_limbs:
            ratio = target_scale / ct.scale
            if abs(ratio - 1) < SCALE_TOL:
                return ct
            if ratio > 1.5:
                # target is a deg-2 scale: integer raise, no level burned
                return self._raise_deg(ct, target_scale)
            assert ct.limbs > self.params.base_limbs, \
                "scale mismatch at base level"
        comp = self.params.comp
        ct = self.level_reduce(ct, min(ct.limbs, target_limbs + comp))
        qd = 1.0
        for i in range(ct.limbs - comp, ct.limbs):
            qd *= float(self.params.q[i])
        m = int(round(target_scale * qd / ct.scale))
        # a zero multiplier would silently zero the ciphertext (observed
        # with runaway scale drift before _anchor existed); fail loudly
        assert m >= 1, (
            f"adjust_to multiplier underflow: scale={ct.scale:.6g} "
            f"target={target_scale:.6g} qd={qd:.6g}")
        w, wsh = self._scalar_limb_consts(m, ct.data.shape[1])
        T = self.tables(ct.limbs)
        self.op_counts["adjust"] += 1
        data = _kj_const_mul(ct.data, w, wsh, T.q_p)
        ct = Ciphertext(data, ct.scale * m, 1, ct.slots, limbs_=ct.limbs)
        return self.rescale(ct)

    def _match_add(self, a: Ciphertext, b: Ciphertext):
        """Equalize (limbs, scale) of two cts for addition.

        Bounded fixpoint: adjust_to may land one limb BELOW the requested
        target (when limbs already match but the scale is off by more than
        SCALE_TOL it burns a level via const-mul + rescale), so a single
        pass can leave the pair one limb apart with matching scales — the
        comp=1 bug exposed by test_multichip::test_sharded_full_sort.
        Loop until both invariants hold; each iteration strictly reduces
        max(limbs) or resolves a scale/degree mismatch, so it terminates
        well inside the iteration bound."""
        for _ in range(16):
            if a.limbs > b.limbs:
                a = self.adjust_to(a, b.limbs, b.scale)
                continue
            if b.limbs > a.limbs:
                b = self.adjust_to(b, a.limbs, a.scale)
                continue
            if abs(a.scale / b.scale - 1) < SCALE_TOL:
                return a, b
            if (a.noise_deg == 1 and b.noise_deg == 2
                    and b.scale / a.scale > 1.5):
                a = self._raise_deg(a, b.scale)
                continue
            if (a.noise_deg == 2 and b.noise_deg == 1
                    and a.scale / b.scale > 1.5):
                b = self._raise_deg(b, a.scale)
                continue
            # same degree (or raise impossible) with mismatched scales:
            # burn one level on both, landing on the canonical scale
            comp = self.params.comp
            a = self.adjust_to(a, a.limbs - comp,
                               self.canonical_scale(a.limbs - comp))
            b = self.adjust_to(b, b.limbs - comp,
                               self.canonical_scale(b.limbs - comp))
        raise AssertionError(
            f"_match_add failed to converge: limbs {a.limbs}/{b.limbs} "
            f"scales {a.scale}/{b.scale}")

    def _raise_deg(self, ct: Ciphertext, target_scale: float) -> Ciphertext:
        """Multiply deg-1 ct by integer ~ target_scale/scale (no rescale)."""
        m = int(round(target_scale / ct.scale))
        assert m >= 1
        w, wsh = self._scalar_limb_consts(m, ct.data.shape[1])
        T = self.tables(ct.limbs)
        data = _kj_const_mul(ct.data, w, wsh, T.q_p)
        return Ciphertext(data, ct.scale * m, 2, ct.slots, limbs_=ct.limbs)

    def _match_components(self, a: Ciphertext, b: Ciphertext):
        """Pad component counts (deg-2 + deg-1 adds)."""
        if a.k == b.k:
            return a, b
        if a.k < b.k:
            a = replace(a, data=jnp.concatenate(
                [a.data, jnp.zeros((b.k - a.k,) + a.data.shape[1:],
                                   dtype=a.data.dtype)], axis=0))
        else:
            b = replace(b, data=jnp.concatenate(
                [b.data, jnp.zeros((a.k - b.k,) + b.data.shape[1:],
                                   dtype=b.data.dtype)], axis=0))
        return a, b

    # ---------------- arithmetic: add/sub ----------------
    def add(self, a: Ciphertext, b) -> Ciphertext:
        if isinstance(b, Ciphertext):
            a, b = self._match_add(a, b)
            a, b = self._match_components(a, b)
            T = self.tables(a.limbs)
            self.op_counts["add"] += 1
            data = _kj_add(a.data, b.data, T.q_p.reshape(1, -1, 1))
            return Ciphertext(data, a.scale, max(a.noise_deg, b.noise_deg),
                              a.slots, limbs_=a.limbs)
        if isinstance(b, Plaintext):
            return self._add_pt(a, b, sub=False)
        return self._add_scalar(a, float(b), sub=False)

    def sub(self, a: Ciphertext, b) -> Ciphertext:
        if isinstance(b, Ciphertext):
            a, b = self._match_add(a, b)
            a, b = self._match_components(a, b)
            T = self.tables(a.limbs)
            self.op_counts["add"] += 1
            data = _kj_sub(a.data, b.data, T.q_p.reshape(1, -1, 1))
            return Ciphertext(data, a.scale, max(a.noise_deg, b.noise_deg),
                              a.slots, limbs_=a.limbs)
        if isinstance(b, Plaintext):
            return self._add_pt(a, b, sub=True)
        return self._add_scalar(a, float(b), sub=True)

    def rsub(self, b, a: Ciphertext) -> Ciphertext:
        """scalar/pt minus ct."""
        return self.negate(self.sub(a, b))

    def negate(self, a: Ciphertext) -> Ciphertext:
        T = self.tables(a.limbs)
        p = T.q_p.reshape(1, -1, 1)
        return replace(a, data=_kj_negate(a.data, p))

    def _add_pt(self, a: Ciphertext, pt: Plaintext, sub: bool) -> Ciphertext:
        rows = a.data.shape[1]
        assert pt.data.shape[0] >= rows, "plaintext too short"
        assert abs(pt.scale / a.scale - 1) < SCALE_TOL, (pt.scale, a.scale)
        T = self.tables(a.limbs)
        p = T.q_p.reshape(1, -1, 1)
        ptd = pt.data[:rows][None]
        c0 = sub_mod(a.data[0:1], ptd, p) if sub else add_mod(
            a.data[0:1], ptd, p)
        return replace(a, data=jnp.concatenate([c0, a.data[1:]], axis=0))

    def _add_scalar(self, a: Ciphertext, c: float, sub: bool) -> Ciphertext:
        """Add/sub a real constant: encode at exact scale on the constant
        coefficient (slot-constant = coefficient-0 constant)."""
        m = int(round(c * a.scale))
        if sub:
            m = -m
        ws = np.array([m % self.params.q[i]
                       for i in range(a.data.shape[1])], dtype=np.uint32)
        # constant poly: value m at coeff 0 -> NTT is constant m across slots
        # (Montgomery form needed)
        wm = np.array([int(w) * ((1 << 32) % self.params.q[i])
                       % self.params.q[i]
                       for i, w in enumerate(ws)], dtype=np.uint32)
        T = self.tables(a.limbs)
        p = T.q_p.reshape(1, -1, 1)
        c0 = add_mod(a.data[0:1], jnp.asarray(wm).reshape(1, -1, 1), p)
        return replace(a, data=jnp.concatenate([c0, a.data[1:]], axis=0))

    # ---------------- arithmetic: mult ----------------
    def mult(self, a: Ciphertext, b) -> Ciphertext:
        """EvalMult (auto-relinearized for ct-ct, lazy rescale semantics)."""
        if isinstance(b, Ciphertext):
            return self._mult_ct(a, b)
        if isinstance(b, Plaintext):
            return self._mult_pt(a, b)
        return self.mult_scalar(a, float(b))

    def _prep_mult(self, a: Ciphertext, b: Ciphertext):
        a = self._anchor(self._ensure_deg1(a))
        b = self._anchor(self._ensure_deg1(b))
        if a.limbs > b.limbs:
            a = self.adjust_to(a, b.limbs, self.canonical_scale(b.limbs)) \
                if abs(a.scale / b.scale - 1) > SCALE_TOL else \
                self.level_reduce(a, b.limbs)
        elif b.limbs > a.limbs:
            b = self.adjust_to(b, a.limbs, self.canonical_scale(a.limbs)) \
                if abs(b.scale / a.scale - 1) > SCALE_TOL else \
                self.level_reduce(b, a.limbs)
        return a, b

    def _mult_ct(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        a, b = self._prep_mult(a, b)
        assert a.k == 2 and b.k == 2, "relinearize before multiplying"
        T = self.tables(a.limbs)
        d = _kj_mult_relin(a.data, b.data, self.relin_key, T)
        self.mult_count += 1
        self.op_counts["mult_relin"] += 1
        return Ciphertext(d, a.scale * b.scale, 2, a.slots, limbs_=a.limbs)

    def square(self, a: Ciphertext) -> Ciphertext:
        a = self._anchor(self._ensure_deg1(a))
        T = self.tables(a.limbs)
        d = _kj_square_relin(a.data, self.relin_key, T)
        self.mult_count += 1
        self.op_counts["square_relin"] += 1
        return Ciphertext(d, a.scale * a.scale, 2, a.slots, limbs_=a.limbs)

    def _mult_pt(self, a: Ciphertext, pt: Plaintext) -> Ciphertext:
        a = self._ensure_deg1(a)
        rows = a.data.shape[1]
        assert pt.data.shape[0] >= rows, "plaintext too short"
        T = self.tables(a.limbs)
        self.op_counts["pt_mul"] += 1
        d = _kj_pt_mul(a.data, pt.data[:rows], T.q_p, T.q_npi)
        return Ciphertext(d, a.scale * pt.scale, 2, a.slots, limbs_=a.limbs)

    def mult_delta(self, ct: Ciphertext) -> float:
        """FLEXIBLEAUTO scaling factor for a scalar/plaintext multiply of
        `ct` (must be deg-1): chosen so the deg-2 product rescales EXACTLY
        onto the canonical ladder — OpenFHE's ScalingFactorReal analogue.
        Encoding at the fresh Delta instead seeds scale drift that the
        _anchor/adjust machinery then burns levels to repair (dozens of
        extra adjusts per N=128 sort)."""
        P = self.params
        l = ct.limbs
        if l - P.comp < P.base_limbs:
            return self.delta
        qd = 1.0
        for i in range(l - P.comp, l):
            qd *= float(P.q[i])
        d = self.canonical_scale(l - P.comp) * qd / ct.scale
        # degenerate drift guard: a wildly off-ladder operand falls back
        # to the fresh Delta (then _anchor repairs as before)
        return d if 1.0 < d < self.delta * self.delta else self.delta

    def mult_scalar(self, a: Ciphertext, c: float) -> Ciphertext:
        """EvalMult(ct, double): scalar at the level's canonical factor."""
        a = self._ensure_deg1(a)
        dl = self.mult_delta(a)
        m = int(round(c * dl))
        w, wsh = self._scalar_limb_consts(m, a.data.shape[1])
        T = self.tables(a.limbs)
        self.op_counts["const_mul"] += 1
        data = _kj_const_mul(a.data, w, wsh, T.q_p)
        return Ciphertext(data, a.scale * dl, 2, a.slots,
                          limbs_=a.limbs)

    def mult_plain(self, ct: Ciphertext, values, slots: int | None = None
                   ) -> Ciphertext:
        """pt-mult with the plaintext encoded at the canonical mult factor
        (mult_delta) for ct's level — keeps mask multiplies on the
        canonical ladder instead of drifting by Delta/S[l]."""
        ct = self._ensure_deg1(ct)
        pt = self.make_plaintext(values, ct.limbs, self.mult_delta(ct),
                                 slots or ct.slots)
        return self.mult(ct, pt)

    def mult_int(self, a: Ciphertext, m: int) -> Ciphertext:
        """Multiply the message by a small integer WITHOUT consuming scale
        or depth (noise grows by |m|).  This is how OpenFHE realises the
        Chebyshev doubling 2*T_a*T_b: EvalAdd(prod, prod) instead of a
        scalar EvalMult — depth-free (Paterson-Stockmeyer inner nodes)."""
        if m == 1:
            return a
        if m == 0:
            return self.zero_like(a)
        w, wsh = self._scalar_limb_consts(m, a.data.shape[1])
        T = self.tables(a.limbs)
        self.op_counts["const_mul"] += 1
        return replace(a, data=_kj_const_mul(a.data, w, wsh, T.q_p))

    # ---------------- relinearization ----------------
    def relinearize(self, ct: Ciphertext) -> Ciphertext:
        if ct.k == 2:
            return ct
        T = self.tables(ct.limbs)
        out = _kj_relin3(ct.data, self.relin_key, T)
        return replace(ct, data=out)

    def _key_rows(self, ksk, l: int, ndig: int):
        nq = self.params.nq
        ksp = self.params.num_special
        rows = np.concatenate([np.arange(l), np.arange(nq, nq + ksp)])
        return ksk[:ndig][:, :, rows, :]

    # ---------------- rotations ----------------
    def rotate(self, ct: Ciphertext, k: int) -> Ciphertext:
        """EvalRotate: left rotation by k slots (key must exist).

        One-shot rotations use the fused single-dispatch kernel; batched
        same-source rotations should go through fast_rotation_precompute /
        fast_rotation (or RotationTree) to share the decomposition."""
        half = self.n // 2
        kk = k % half
        if kk == 0 or k % ct.slots == 0:
            return ct
        assert kk in self.rot_keys, f"missing rotation key {k}"
        T = self.tables(ct.limbs)
        out = _kj_rotate_fused(ct.data, self.rot_keys[kk], self._perm(kk), T)
        self.rot_count += 1
        self.op_counts["rotate_fused"] += 1
        return replace(ct, data=out)

    def fast_rotation_precompute(self, ct: Ciphertext):
        """Hoisted decomposition of c1 (EvalFastRotationPrecompute)."""
        T = self.tables(ct.limbs)
        self.precompute_count += 1
        self.op_counts["decompose"] += 1
        return _kj_decompose(ct.data[1], T)

    def fast_rotation(self, ct: Ciphertext, k: int, precomp) -> Ciphertext:
        half = self.n // 2
        kk = k % half
        if kk == 0 or k % ct.slots == 0:
            return ct
        assert kk in self.rot_keys, f"missing rotation key {k}"
        T = self.tables(ct.limbs)
        perm = self._perm(kk)
        out = _kj_fast_rotate(ct.data, precomp, self.rot_keys[kk], perm, T)
        self.rot_count += 1
        self.op_counts["fast_rotate"] += 1
        return replace(ct, data=out)

    def rotate_raw(self, ct: Ciphertext, k: int) -> Ciphertext:
        """Rotation WITHOUT the slots-period shortcut: applies the Galois
        automorphism even when k is a multiple of ct.slots.  Required by
        bootstrapping's subring trace, which rotates by multiples of the
        slot period to act on the mod-raise error (the message part is
        period-invariant but the error is dense)."""
        kk = k % (self.n // 2)
        if kk == 0:
            return ct
        assert kk in self.rot_keys, f"missing rotation key {k}"
        T = self.tables(ct.limbs)
        out = _kj_rotate_fused(ct.data, self.rot_keys[kk],
                               self._perm(kk), T)
        self.rot_count += 1
        self.op_counts["rotate_fused"] += 1
        return replace(ct, data=out)

    # ---------------- conjugation ----------------
    def gen_conj_key(self):
        """Galois key for complex conjugation (element 2n-1)."""
        if getattr(self, "conj_key", None) is None:
            if self.keygen is None:
                raise KeyError("evaluation-only context is missing the "
                               "conjugation key")
            self.conj_key = jnp.asarray(
                self.keygen.gen_rotation_key(2 * self.n - 1))

    def conjugate(self, ct: Ciphertext) -> Ciphertext:
        """EvalConjugate: slot-wise complex conjugation (sigma_{2n-1})."""
        assert getattr(self, "conj_key", None) is not None, \
            "call gen_conj_key() first"
        ct = self._ensure_deg1(ct)
        if not hasattr(self, "_conj_perm"):
            self._conj_perm = jnp.asarray(
                encoding.automorphism_eval_perm(
                    self.n, 2 * self.n - 1).astype(np.int32))
        T = self.tables(ct.limbs)
        out = _kj_rotate_fused(ct.data, self.conj_key, self._conj_perm, T)
        self.rot_count += 1
        self.op_counts["rotate_fused"] += 1
        return replace(ct, data=out)

    # ---------------- plaintext rotation (free: no key switch) ----------
    def rotate_plaintext(self, pt: Plaintext, r: int) -> Plaintext:
        """Slot-rotate a PLAINTEXT by r via the Galois automorphism — a
        pure eval-domain permutation (no key switch, no re-encoding).

        encode(roll(v, -r)) == sigma_g(encode(v)) exactly: the
        automorphism is an integer-coefficient permutation commuting with
        the embedding.  Replaces per-mask host iFFT + RNS reduction +
        48 MB transfers in the baby-step mask families (~130 masks per
        N=128 sort)."""
        kk = r % (self.n // 2)
        if kk == 0:
            return pt
        self.op_counts["pt_rotate"] += 1
        return Plaintext(_kj_permute(pt.data, self._perm(kk)),
                         pt.scale, pt.slots)

    # ---------------- monomial multiplication (free: no key, no level) ----
    def mult_monomial(self, ct: Ciphertext, power: int) -> Ciphertext:
        """Multiply by X^power (power mod 2n).  Multiplying by X^{n/2}
        multiplies every slot by i, X^{3n/2} by -i — noiseless, depth-free
        complex bookkeeping for bootstrap's real/imag split."""
        power %= 2 * self.n
        if power == 0:
            return ct
        key = ("mono", power, ct.data.shape[1])
        mono = self._pt_get(key)
        if mono is None:
            neg = power >= self.n
            k = power - self.n if neg else power
            limbs = ct.data.shape[1]
            rows = np.zeros((limbs, self.n), dtype=np.uint32)
            for i in range(limbs):
                # plain +-1 at coefficient k; _to_eval_domain applies the
                # Montgomery factor and the forward NTT
                rows[i, k] = (self.params.q[i] - 1) if neg else 1
            mono = self._pt_put(key, self._to_eval_domain(rows, limbs),
                                limbs * self.n * 4)
        T = self.tables(ct.limbs)
        d = _kj_pt_mul(ct.data, mono, T.q_p, T.q_npi)
        return replace(ct, data=d)

    # ---------------- mod raise (bootstrap step 1) ----------------
    def mod_raise(self, ct: Ciphertext) -> Ciphertext:
        """Re-interpret a low-level ciphertext at the full modulus chain.

        The output decrypts to m + D*I for the small integer polynomial I
        (|I| bounded by the secret's Hamming weight), D = prod(q[:limbs]).
        First step of EvalBootstrap (OpenFHE EvalBootstrap's ModRaise;
        consumed by /root/reference/src/sort_algo.h:1436-1438 et al.)."""
        l0 = ct.limbs
        nq = self.params.nq
        assert l0 < nq, "already at full level"
        key = ("raise", l0)
        consts = self._pt_get(key)
        if consts is None:
            q = self.params.q
            R = 1 << 32
            D = 1
            for i in range(l0):
                D *= q[i]
            w = np.empty(l0, dtype=np.uint32)
            wsh = np.empty(l0, dtype=np.uint32)
            Cw = np.zeros((l0, nq), dtype=np.uint32)
            Csh = np.zeros_like(Cw)
            dinv = np.empty(l0, dtype=np.float32)
            for i in range(l0):
                d = q[i]
                dh = D // d
                c = nt.mod_inverse(dh % d, d) * nt.mod_inverse(R % d, d) % d
                w[i] = c
                wsh[i] = (c << 32) // d
                dinv[i] = np.float32(1.0 / d)
                for r in range(nq):
                    pr = q[r]
                    cc = (dh % pr) * (R % pr) % pr
                    Cw[i, r] = cc
                    Csh[i, r] = (cc << 32) // pr
            DmodR = np.array([(D % p) * (R % p) % p for p in q],
                             dtype=np.uint32)
            DmodR_sh = np.array([(int(v) << 32) // p
                                 for v, p in zip(DmodR, q)], dtype=np.uint32)
            with _concrete_ctx():
                consts = self._pt_put(key, tuple(map(jnp.asarray, (
                    w, wsh, Cw, Csh, dinv, DmodR, DmodR_sh))),
                    (2 * l0 + l0 * 2 * nq + 3 * nq) * 4)
        w, wsh, Cw, Csh, dinv, DmodR, DmodR_sh = consts
        # slice to the LOGICAL limbs: mod_raise interprets the rows as the
        # complete RNS representation mod D = prod(q[:l0]) — bucket-padding
        # garbage rows would corrupt the lift
        dat = ct.data[:, :l0, :] if ct.data.shape[1] > l0 else ct.data
        data = _kj_mod_raise(dat, w, wsh, Cw, Csh, dinv, DmodR, DmodR_sh,
                             self.tables_exact(l0), self.tables(nq))
        return Ciphertext(data, ct.scale, 1, ct.slots)

    # ---------------- client-side debug ----------------
    def decrypt_debug(self, ct: Ciphertext, count: int | None = None):
        v = self.decrypt(ct)
        return v[: (count or ct.slots)]
