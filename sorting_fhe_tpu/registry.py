"""Per-(algorithm, N) parameter registry.

One declarative table replacing the reference's scattered per-N parameter
blocks (SURVEY.md §5.6):

  * DirectSort::getSizeParameters   /root/reference/src/sort_algo.h:87-201
  * hybrid test fixtures            /root/reference/tests/DirectSortHTest.cpp:28-104,
                                    DirectSortH1Test.cpp:40-113, DirectSortH2Test.cpp
  * MEHP24 fixture                  /root/reference/tests/mehp24/Mehp24SortTest.cpp:39-72
  * KWayAdapter::getSizeParameters  /root/reference/src/kway_adapter.h:41-64
  * BitonicSort fixture             /root/reference/tests/BitonicSortTest.cpp:20-55
  * sign-config ladder              /root/reference/tests/DirectSortTest.cpp:113-121

plus this runtime's uint32 CKKS mapping: the reference's 40-bit OpenFHE scaling
prime becomes a composite pair of ~26-bit uint32 primes (scale_bits=52,
comp=2) — at ring 2^17 there are no 20-bit NTT primes, so 52 is the
smallest per-level budget a composite uint32 chain can realise; precision
is strictly better than the reference's.

Security: HEStd_128_classic logQP ceilings per ring dimension from the
homomorphicencryption.org standard table (ternary secret, classical).
`security_check` reports the built chain's logQP against the ceiling —
the equivalent of OpenFHE validating HEStd_128_classic at context
creation (reference sets it at tests/DirectSortTest.cpp:35-37).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .core.params import CkksConfig

# HE standard (homomorphicencryption.org, 128-bit classical, ternary secret):
# max log2(QP) per ring dimension.
HESTD_128_CLASSIC_LOGQP = {
    1 << 10: 27, 1 << 11: 54, 1 << 12: 109, 1 << 13: 218,
    1 << 14: 438, 1 << 15: 881, 1 << 16: 1772, 1 << 17: 3523,
    1 << 18: 7101,
}


def sign_ladder(N: int) -> tuple[int, int, int]:
    """CompositeSign(n, dg, df) ladder (DirectSortTest.cpp:113-121,
    DirectSortH1Test.cpp:172-181, Mehp24SortTest.cpp:126-135)."""
    if N <= 16:
        return (3, 2, 2)
    if N <= 128:
        return (3, 3, 2)
    if N <= 512:
        return (3, 4, 2)
    return (3, 5, 2)


@dataclass(frozen=True)
class SortParams:
    """Depth-matched crypto + key material spec for one (algorithm, N)."""
    algo: str
    N: int
    mult_depth: int                     # reference multDepth at scaleMod 40
    rotations: tuple[int, ...] = ()     # EvalRotateKeyGen index list
    sign: tuple[int, int, int] | None = None   # CompositeSign(n, dg, df)
    ring_dim_full: int = 1 << 17
    level_budget: tuple[int, int] | None = None  # bootstrap budgets (k-way)

    def sign_config(self):
        from .ops.sign import SignConfig, CompositeSignConfig
        n, dg, df = self.sign or sign_ladder(self.N)
        return SignConfig(CompositeSignConfig(n, dg, df),
                          mult_depth=self.mult_depth)


def _pow2_pm(N: int) -> tuple[int, ...]:
    """{+-2^i : 2^i < N} (kway_adapter.h:50-54, BitonicSortTest.cpp:33-36)."""
    out = []
    i = 1
    while i < N:
        out += [i, -i]
        i *= 2
    return tuple(out)


# ---------------------------------------------------------------------------
# DirectSort (plain): sort_algo.h:87-201
# ---------------------------------------------------------------------------
_DIRECT_DEPTH = {4: 23, 8: 24, 16: 25, 32: 28, 64: 29, 128: 30, 256: 34,
                 512: 35, 1024: 39, 2048: 52}

# Hybrid (sinc) fixture: DirectSortHTest.cpp:28-104
_HYBRID_DEPTH = {4: 24, 8: 25, 16: 25, 32: 29, 64: 30, 128: 31, 256: 44,
                 512: 47, 1024: 50}
_HYBRID_ROTS = {
    4: (1, 2, 3, 4, 6, 8),
    8: (1, 2, 4, 6, 7, 8, 14, 16, 28, 32),
    16: (1, 2, 3, 4, 8, 12, 15, 16, 30, 32, 60, 64, 120, 128),
    32: (1, 2, 3, 4, 8, 12, 16, 20, 24, 28, 31, 32, 62, 64, 124, 128,
         248, 256, 496, 512),
    64: (1, 2, 3, 4, 6, 7, 8, 16, 24, 32, 40, 48, 56, 63, 64, 126, 128,
         252, 256, 504, 512, 1008, 1024, 2016, 2048),
    128: (1, 2, 3, 4, 5, 6, 7, 8, 16, 24, 32, 40, 48, 56, 64, 72, 80, 88,
          96, 104, 112, 120, 127, 128, 254, 256, 508, 512, 1016, 1024,
          2032, 2048, 4064, 4096, 8128, 8192),
    256: (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 32, 48,
          64, 80, 96, 112, 128, 144, 160, 176, 192, 208, 224, 240, 255,
          256, 510, 512, 1020, 1024, 2040, 2048, 4080, 4096, 8160, 8192,
          16320, 16384, 32640, 32768),
    512: (-255, -1, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
          32, 48, 64, 80, 96, 112, 128, 144, 160, 176, 192, 208, 224, 240,
          255, 256, 272, 288, 304, 320, 336, 352, 368, 384, 400, 416, 432,
          448, 464, 480, 496, 510, 512, 1020, 1024, 2040, 2048, 4080, 4096,
          8160, 8192, 16320, 16384, 32640, 32768),
    1024: (-510, -255, -2, -1, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13,
           14, 15, 16, 17, 28, 18, 20, 21, 22, 23, 24, 25, 26, 27, 29, 30,
           31, 32, 64, 96, 128, 160, 192, 224, 255, 256, 288, 320, 352,
           384, 416, 448, 480, 510, 512, 544, 576, 608, 640, 672, 704,
           736, 768, 800, 832, 864, 896, 928, 960, 992, 1020, 1024, 2040,
           2048, 4080, 4096, 8160, 8192, 16320, 16384, 32640, 32768),
}

# H1 fixture depths: DirectSortH1Test.cpp:40-113 (rotations = _HYBRID_ROTS)
_H1_DEPTH = {4: 31, 8: 35, 16: 35, 32: 42, 64: 42, 128: 46, 256: 49,
             512: 53, 1024: 56}

# H2 fixture depths: DirectSortH2Test.cpp:28-104
_H2_DEPTH = {4: 24, 8: 25, 16: 25, 32: 29, 64: 30, 128: 31, 256: 35,
             512: 36, 1024: 40}

# MEHP24 depths: measured consumption + 2 margin (+4 for the multi-ct
# split tier N>256).  Measured on the CPU tier: sortFG consumes
# 8 + 3(dg_c+df_c) + 3(dg_i+df_i) levels (N=4: 29, N=8/16: 32 — canonical
# -factor plaintext encodes avoid the adjust/anchor levels that would
# cost +3 over the reference).  Reference fixtures for
# comparison: 31/35/35/42/42/46/49/57/60 (Mehp24SortTest.cpp:39-72) —
# ours are now at-or-below the fixture at every N.
_MEHP_DEPTH = {4: 31, 8: 34, 16: 34, 32: 40, 64: 40, 128: 43, 256: 46,
               512: 51, 1024: 54, 2048: 58}


def _fits_2e17(depth: int, scale_bits: int = 56) -> bool:
    """Model check: can ANY dnum keep logQP within the ring-2^17 HEStd
    ceiling at this depth?  (uint32-RNS tax: our 56-bit level pairs are
    fatter than the reference's 40-bit primes, so very deep chains that
    fit OpenFHE at 2^17 need ring 2^18 here; the model is calibrated
    -1 depth vs the built depth-56 chain.)"""
    limit = HESTD_128_CLASSIC_LOGQP[1 << 17]
    logq = 3 * 30 + depth * scale_bits
    nq = 3 + 2 * depth
    ksp = -(-nq // 14)                       # largest supported dnum
    # +31 slack: the built depth-56 chain comes in 54 bits over this
    # model, so require one special prime of margin
    return logq + ksp * 31 + 31 <= limit


def _ring_for(depth: int) -> int:
    return (1 << 17) if _fits_2e17(depth) else (1 << 18)


def _build() -> dict[tuple[str, int], SortParams]:
    from .models.direct_sort import DIRECT_SORT_ROTATIONS
    reg: dict[tuple[str, int], SortParams] = {}
    for N, d in _DIRECT_DEPTH.items():
        reg[("direct", N)] = SortParams(
            "direct", N, d, tuple(DIRECT_SORT_ROTATIONS[N]),
            ring_dim_full=_ring_for(d))
    for N, d in _HYBRID_DEPTH.items():
        reg[("hybrid", N)] = SortParams("hybrid", N, d, _HYBRID_ROTS[N],
                                        ring_dim_full=_ring_for(d))
    for N, d in _H1_DEPTH.items():
        reg[("hybrid1", N)] = SortParams("hybrid1", N, d, _HYBRID_ROTS[N],
                                         ring_dim_full=_ring_for(d))
    for N, d in _H2_DEPTH.items():
        reg[("hybrid2", N)] = SortParams("hybrid2", N, d, _HYBRID_ROTS[N],
                                         ring_dim_full=_ring_for(d))
    for N, d in _MEHP_DEPTH.items():
        reg[("mehp24", N)] = SortParams("mehp24", N, d,
                                        ring_dim_full=_ring_for(d))
    for N in (4, 8, 16, 32, 64, 128, 256, 512, 1024):
        # Sign (4,3,3) per BitonicSortTest.cpp:72.  Depth: the fixture's
        # 58 (cheap ring 2^12, 40-bit scales) does NOT fit HEStd-128 at
        # ring 2^17 with 56-bit uint32 level pairs; 52 does (dnum 8,
        # modeled logQP 3467), and covers one ~30-level stage (mask +
        # CompositeSign(4,3,3) + select) plus the ~16-level bootstrap
        # between stages (sort_algo.h:1436-1438 boots at consumed > 29).
        reg[("bitonic", N)] = SortParams(
            "bitonic", N, 52, _pow2_pm(N), sign=(4, 3, 3),
            ring_dim_full=_ring_for(52))
    # k-way grids: N = k^M for k in {2, 3, 5} (kway_adapter.h:41-64 depth
    # 40, budgets {4,4} N<=128 / {5,5}; per-size CompositeSignConfig(3,
    # d_f, d_g) ladders from tests/k-way/KWaySort{2,3,5}Test.cpp:85-140 —
    # note the reference passes (n, dg=d_f, df=d_g), d_f fixed at 2)
    kway_sign = {
        4: (3, 2, 2), 8: (3, 2, 2), 16: (3, 2, 2),
        32: (3, 2, 3), 64: (3, 2, 3), 128: (3, 2, 3),
        256: (3, 2, 4), 512: (3, 2, 4), 1024: (3, 2, 5),
        9: (3, 2, 2), 27: (3, 2, 3), 81: (3, 2, 3),
        243: (3, 2, 4), 729: (3, 2, 5),
        25: (3, 2, 3), 125: (3, 2, 3), 625: (3, 2, 4),
    }
    for N, sgn in kway_sign.items():
        np2 = 1 << (N - 1).bit_length()   # batch = next pow2 (adapter h:44)
        reg[("kway", N)] = SortParams(
            "kway", N, 40, _pow2_pm(np2), sign=sgn,
            level_budget=(4, 4) if N <= 128 else (5, 5))
    return reg


REGISTRY = _build()


def get_params(algo: str, N: int) -> SortParams:
    try:
        return REGISTRY[(algo, N)]
    except KeyError:
        raise KeyError(f"no registered parameters for ({algo!r}, N={N}); "
                       f"known: {sorted(REGISTRY)}") from None


def _dnum_for(depth: int, ring_dim: int, scale_bits: int = 56) -> int:
    """Smallest dnum whose special-prime block keeps logQP within (or as
    close as possible to) the 128-bit ceiling.

    Prime-size model: level pairs average scale_bits total (the pool
    pair-picker lands within ~2^-8), special primes ~31 bits.  A 26/30-bit
    estimate would pick dnum=3 for depth 46, whose real chain has logQP
    3547 > 3523."""
    limit = HESTD_128_CLASSIC_LOGQP.get(ring_dim)
    best = 3
    for dnum in (3, 4, 5, 6, 8, 10, 12, 14):
        nq = 3 + 2 * depth                      # base(3x30b) + depth pairs
        logq = 3 * 30 + depth * scale_bits
        ksp = -(-nq // dnum)
        logqp = logq + ksp * 31
        best = dnum
        # +31 margin: built chains run ~1 bit/level over this model
        # (the depth-56 chain has logQP 3559 vs modeled 3505)
        if limit is None or logqp + 31 <= limit:
            break
    return best


def full_config(p: SortParams, **overrides) -> CkksConfig:
    """Depth-matched full-fidelity CkksConfig (ring 2^17 tier).

    scale_bits=56: at ring 2^17 the NTT prime pool has only ~10 26-bit
    members — 52-bit levels exhaust them by depth ~27 and the canonical
    ladder diverges.  56-bit levels draw on the
    dense 27-29-bit pool (~80 realizable pairs, depth 56 covered) and
    carry MORE precision than the reference's 40-bit scaling mod.

    limb_pad=8: bucket the ~2*depth distinct limb counts of a deep chain
    into multiples of 8 so the per-(kernel, limb-count) XLA compiles drop
    ~8x (see CkksConfig.limb_pad)."""
    # resolve scale_bits from overrides BEFORE sizing dnum: a caller
    # overriding scale_bits changes the level-prime budget logQP is
    # modeled from
    sb = overrides.get("scale_bits", 56)
    kw = dict(ring_dim=p.ring_dim_full, mult_depth=p.mult_depth,
              scale_bits=sb, comp=2,
              dnum=_dnum_for(p.mult_depth, p.ring_dim_full, sb),
              batch_size=None, limb_pad=8)
    kw.update(overrides)
    return CkksConfig(**kw)


def cheap_config(p: SortParams, ring_log: int = 10, **overrides) -> CkksConfig:
    """Unit-test tier: small ring, no security claim (reference pattern:
    HEStd_NotSet fixtures, SURVEY.md §4.1)."""
    kw = dict(ring_dim=1 << ring_log, mult_depth=p.mult_depth,
              scale_bits=52, comp=2, dnum=3, batch_size=None)
    kw.update(overrides)
    return CkksConfig(**kw)


def security_check(cfg: CkksConfig, params=None) -> tuple[int, int | None, bool]:
    """(logQP, ceiling, ok): lattice-security budget check for a built or
    to-be-built chain.  Pass the CkksParams to measure the exact chain;
    otherwise estimates from the config."""
    if params is not None:
        logqp = sum(int(p).bit_length() for p in params.all_primes)
    else:
        nq = 3 + cfg.comp * cfg.mult_depth
        ksp = -(-nq // cfg.dnum)
        logqp = (3 * cfg.base_mod_bits
                 + cfg.comp * cfg.mult_depth * (cfg.scale_bits // cfg.comp)
                 + ksp * 30)
    limit = HESTD_128_CLASSIC_LOGQP.get(cfg.ring_dim)
    return logqp, limit, (limit is None or logqp <= limit)


_ = field
