"""DirectSort: SIMD-batched rank construction + sinc-kernel oblivious
permutation ("rotation index checking").

JAX rebuild of /root/reference/src/sort_algo.h:61-774 (the repo's own
algorithm, eprint 2025/1170):

  constructRank        (sort_algo.h:368-506)  rank_i = sum_s compare(x, rot(x, s))
      with slot packing: num_partition = min(N, max_batch/N) shifted copies
      per ciphertext, so only num_batch = N/num_partition sign evaluations.
  rotationIndexCheckN  (sort_algo.h:658-750)  output_j = sum_r
      doubled_sinc((j - rank - r)/2N) * x_r  via one Chebyshev series per
      batch and baby-step/giant-step blind rotations.

The OpenMP parallel-for/critical accumulation patterns of the reference
become pure-functional accumulation; the SIMD batching maps onto full-width
device ciphertext ops.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.ckks import CkksContext, Ciphertext
from ..core.poly_eval import eval_chebyshev_series_ps
from ..ops.sign import SignFunc, SignConfig, CompositeSignConfig
from ..ops.comparison import compare, indicator as _indicator
from ..ops.rotation import RotationComposer, RotationTree, DecomposeAlgo
from ..ops.chebyshev import doubled_sinc_coefficients, sinc_coefficients
from .mehp24 import indicator_adv as _indicator_adv


# Rotation-key index lists per N (spec data ported from the reference's
# parameter tables, sort_algo.h:94-197: baby-step strides + powers of two).
DIRECT_SORT_ROTATIONS: dict[int, list[int]] = {
    4: [1, 2, 4, 8, 16],
    8: [1, 2, 4, 6, 8, 16, 32, 64],
    16: [1, 2, 3, 4, 8, 12, 16, 32, 64, 128, 256],
    32: [1, 2, 3, 4, 8, 12, 16, 20, 24, 28, 32, 64, 128, 256, 512, 1024],
    64: [1, 2, 3, 4, 5, 6, 7, 8, 16, 24, 32, 40, 48, 56, 64, 128, 256, 512,
         1024, 2048, 4096],
    128: [1, 2, 3, 4, 5, 6, 7, 8, 16, 24, 32, 40, 48, 56, 64, 72, 80, 88,
          96, 104, 112, 120, 128, 256, 512, 1024, 2048, 4096, 8192, 16384],
    256: [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 24, 32,
          40, 48, 56, 64, 72, 80, 88, 96, 104, 112, 120, 128, 129, 130,
          131, 132, 133, 134, 135, 144, 160, 176, 192, 208, 224, 240, 256,
          512, 1024, 2048, 4096, 8192, 16384, 32768],
}

# N=512: 64-strided blocks with 0-7 offsets + 16-strides (sort_algo.h:133-146)
DIRECT_SORT_ROTATIONS[512] = (
    list(range(1, 17)) + [24, 32, 40, 48, 56]
    + sorted({64 * b + o for b in range(1, 8) for o in range(8)}
             | {64 * b + o for b in range(8) for o in (16, 32, 48)}
             | {512, 1024, 2048, 4096, 8192, 16384, 32768}))

# N=1024: 1..35, then 32-strided blocks with 0-3 offsets (sort_algo.h:147-163)
DIRECT_SORT_ROTATIONS[1024] = (
    list(range(1, 36))
    + sorted({32 * b + o for b in range(2, 32) for o in range(4)}
             | {1024, 2048, 4096, 8192, 16384, 32768}))

# N=2048: the reference's irregular single-hop index set, ported verbatim
# as parameter data (sort_algo.h:166-196; exercised by
# tests/DirectSortNTest.cpp:384-389).  Structure: NAF-flavored baby steps
# below 2048 for the np=32 check-phase groups, then powers of two.
DIRECT_SORT_ROTATIONS[2048] = [
    1, 2, 4, 8, 16, 31, 32, 64, 115, 128, 179, 211, 227, 241, 242, 243,
    256, 307, 339, 355, 369, 370, 371, 403, 419, 433, 434, 435, 451, 465,
    466, 467, 481, 482, 483, 496, 497, 498, 499, 512, 563, 595, 611, 625,
    626, 627, 659, 675, 689, 690, 691, 707, 721, 722, 723, 737, 738, 739,
    752, 753, 754, 755, 787, 803, 817, 818, 819, 835, 849, 850, 851, 865,
    866, 867, 880, 881, 882, 883, 899, 913, 914, 915, 929, 930, 931, 944,
    945, 946, 947, 961, 962, 963, 976, 977, 978, 979, 992, 993, 994, 995,
    1008, 1009, 1010, 1011, 1024, 1075, 1107, 1123, 1137, 1138, 1139,
    1171, 1187, 1201, 1202, 1203, 1219, 1233, 1234, 1235, 1249, 1250,
    1251, 1264, 1265, 1266, 1267, 1299, 1315, 1329, 1330, 1331, 1347,
    1361, 1362, 1363, 1377, 1378, 1379, 1392, 1393, 1394, 1395, 1411,
    1425, 1426, 1427, 1441, 1442, 1443, 1456, 1457, 1458, 1459, 1473,
    1474, 1475, 1488, 1489, 1490, 1491, 1504, 1505, 1506, 1507, 1520,
    1521, 1522, 1523, 1555, 1571, 1585, 1586, 1587, 1603, 1617, 1618,
    1619, 1633, 1634, 1635, 1648, 1649, 1650, 1651, 1667, 1681, 1682,
    1683, 1697, 1698, 1699, 1712, 1713, 1714, 1715, 1729, 1730, 1731,
    1744, 1745, 1746, 1747, 1760, 1761, 1762, 1763, 1776, 1777, 1778,
    1779, 1795, 1809, 1810, 1811, 1825, 1826, 1827, 1840, 1841, 1842,
    1843, 1857, 1858, 1859, 1872, 1873, 1874, 1875, 1888, 1889, 1890,
    1891, 1904, 1905, 1906, 1907, 1921, 1922, 1923, 1937, 1938, 1939,
    1953, 1954, 1955, 1968, 1969, 1970, 1971, 1985, 1986, 1987, 2000,
    2001, 2002, 2003, 2016, 2017, 2018, 2019, 2032, 2033, 2034, 2035,
    2048, 4096, 8192, 16384, 32768]

def minimal_rotations(N: int, max_batch: int = 1 << 16,
                      cap_log2: int = 10) -> list[int]:
    """Power-of-two key set: every rotation the pipelines need composes
    from these via the binary decomposer.  ~2.5x fewer keys than the
    reference's single-hop tables — the memory-saving choice on one card,
    at the cost of ~1 extra key-switch per composed rotation.  Covers the
    hybrid ladders too (sum/transpose-to-target steps are sums of powers
    of two below N^2).  Enabled via DirectSort(use_minimal_keys=True).

    cap_log2 bounds the top key at 2^cap_log2: each keyswitch key is
    ~0.5 GiB at ring 2^17/dnum 4, and the few large tree-reduction
    rotations (2^11..2^13 at N=128) compose from repeated 2^cap_log2
    steps — ~2 dozen extra key-switches per sort save ~1.5 GiB of keys.
    Whether the card would rather hold those keys is not measured yet."""
    num_partition = min(N, max_batch // N)
    num_slots = max(N * num_partition, min(N * N, 2 * max_batch) // 2)
    # top exponent is num_slots/2: composed rotations are always reduced
    # mod num_slots, so a key at exactly num_slots is either dropped
    # (kk==0) or dead weight (~0.4 GiB at ring 2^17)
    top = min(int(np.log2(num_slots)), cap_log2 + 1)
    return [1 << i for i in range(top)]


# baby-step counts (sort_algo.h:382-416 for constructRank;
# sort_algo.h:670-703 for rotationIndexCheckN)
_NP_RANK = {4: 2, 8: 2, 16: 4, 32: 4, 64: 8, 128: 8, 256: 16, 512: 16,
            1024: 32, 2048: 32}
_NP_CHECK = {4: 2, 8: 2, 16: 4, 32: 4, 64: 8, 128: 8, 256: 16, 512: 8,
             1024: 8, 2048: 4}   # 2048: the reference's default arm (:700)

# sign-config ladder used by the reference's tests
# (tests/DirectSortTest.cpp:113-121)
def default_sign_config(N: int) -> SignConfig:
    if N <= 16:
        dg = 2
    elif N <= 128:
        dg = 3
    elif N <= 512:
        dg = 4
    else:
        dg = 5
    return SignConfig(CompositeSignConfig(3, dg, 2))


def _rotate_list(vec: np.ndarray, k: int) -> np.ndarray:
    """Plaintext vector left-rotate (vectorRotate, sort_algo.h:289-306)."""
    return np.roll(vec, -k)


@dataclass
class DirectSort:
    """Template-parameter N becomes a constructor arg; the crypto context
    plays CryptoContext + keys.

    use_minimal_keys: generate only the power-of-two key ladder
    (minimal_rotations) and compose every other index through the binary
    decomposer.  At full fidelity (depth 46, ring 2^17) the reference's
    single-hop key set is ~40 keys x ~0.4 GiB, while the pow-2 ladder
    needs ~2.5x fewer keys, trading ~1 extra key-switch per composed
    rotation."""
    ctx: CkksContext
    N: int
    rot_indices: list[int] = field(default_factory=list)
    sign_func: SignFunc = SignFunc.CompositeSign
    use_minimal_keys: bool = False

    def __post_init__(self):
        if self.use_minimal_keys:
            self.rot_indices = minimal_rotations(self.N, self.ctx.n // 2)
        elif not self.rot_indices:
            self.rot_indices = DIRECT_SORT_ROTATIONS[self.N]
        self.ctx.gen_rotation_keys(self.rot_indices)
        # wrap bounds the binary recoder's bit range.  Registry mode keeps
        # the reference's <N bound (every composed index there acts on
        # N-periodic content; larger indices all have dedicated keys).
        # Minimal-key mode composes arbitrary indices on num_slots-periodic
        # content, so the recoder must emit bits up to the physical period.
        wrap = self.ctx.n // 2 if self.use_minimal_keys else self.N
        self.rot = RotationComposer(self.ctx, self.rot_indices, wrap,
                                    DecomposeAlgo.BINARY)
        # hoisting tree for baby-step batches: rotations of one source
        # share decomposition prefixes and hoisting precomputes
        # (reference rotation.h:240-358)
        self.tree = RotationTree(self.ctx, self.rot_indices, wrap,
                                 DecomposeAlgo.BINARY)
        self.max_batch = self.ctx.n // 2

    def _batch_rotate(self, src: Ciphertext, indices) -> list[Ciphertext]:
        """Rotate one source by many indices with shared hoisting
        (EvalFastRotationPrecompute shared across same-source rotations,
        reference rotation.h:285-348)."""
        self.tree.attach(src)
        return [self.tree.rotate(i) for i in indices]

    # ---------------- mask generators (sort_algo.h:203-287) ----------------
    def _mask(self, num_slots: int, k: int, width: int) -> np.ndarray:
        v = np.zeros(num_slots)
        v[k * width:(k + 1) * width] = 1.0
        return v

    def _index_vector(self) -> np.ndarray:
        return np.arange(self.N, dtype=np.float64)

    def _checking_vector_n(self, num_slots: int, k: int) -> np.ndarray:
        """[k,k,..,k, k+1,...] each value N times, wrapping mod N
        (generateCheckingVectorN, sort_algo.h:272-286)."""
        reps = num_slots // self.N
        ks = (k + np.arange(reps)) % self.N
        return np.repeat(ks.astype(np.float64), self.N)

    def _checking_vector_2n(self, num_slots: int, k: int) -> np.ndarray:
        """[k]*N + [-N+k]*N pattern (generateCheckingVector2N,
        sort_algo.h:252-271)."""
        out = np.empty(num_slots)
        idx = 0
        cur = k
        while idx < num_slots:
            take = min(self.N, num_slots - idx)
            out[idx:idx + take] = cur
            idx += take
            take = min(self.N, num_slots - idx)
            out[idx:idx + take] = -self.N + cur
            idx += take
            cur = (cur + 1) % self.N
        return out

    def _pt(self, vec: np.ndarray, ct: Ciphertext, num_slots: int):
        return self.ctx.make_plaintext(vec, ct.limbs, self.ctx.delta,
                                       num_slots)

    def _pt_block(self, ct: Ciphertext, num_slots: int, width: int,
                  k: int, s: int):
        """Plaintext of _rotate_list(_mask(num_slots, k, width), s) from
        ONE cached base-block encode + a device Galois permutation
        (ckks.rotate_plaintext) — the baby-step mask families are all
        slot-rolls of the same block, and re-encoding/transferring each
        (~48 MB at ring 2^17, ~130 masks per N=128 sort) would cost a
        host encode and a transfer each."""
        base = self._pt(self._mask(num_slots, 0, width), ct, num_slots)
        return self.ctx.rotate_plaintext(base, -(k * width - s))

    # ---------------- constructRank (sort_algo.h:368-506) ----------------
    def construct_rank(self, input_array: Ciphertext,
                       cfg: SignConfig) -> Ciphertext:
        N = self.N
        ctx = self.ctx
        num_partition = min(N, self.max_batch // N)
        num_batch = N // num_partition
        num_slots = N * num_partition
        np_ = min(_NP_RANK[N], num_partition)

        # baby-step pre-rotations of the input: one source, np_ targets —
        # hoisted through the rotation tree (shared precompute)
        babies = [b.with_slots(num_slots)
                  for b in self._batch_rotate(input_array, range(np_))]

        rank = None
        dup = input_array.with_slots(num_slots)
        for i in range(num_batch):
            shifted = self._vec_rots_opt(babies, num_partition, num_slots,
                                         np_, i)
            comp = compare(ctx, dup, shifted, self.sign_func, cfg)
            rank = comp if rank is None else ctx.add(rank, comp)

        # log-tree reduction over partitions
        for i in range(1, int(np.log2(num_partition)) + 1):
            rank = ctx.add(rank, self.rot.rotate(rank, num_slots >> i))
        rank = rank.with_slots(N)
        # compensate self-comparison (compare(x,x) = 0.5)
        return ctx.sub(rank, 0.5)

    def _vec_rots_opt(self, babies, num_partition, num_slots, np_, is_):
        """One composed rotation per np_-group of masked baby steps
        (vecRotsOpt, sort_algo.h:326-366)."""
        ctx = self.ctx
        result = None
        for j in range(num_partition // np_):
            T = None
            for i in range(np_):
                pt = self._pt_block(babies[i], num_slots, self.N,
                                    np_ * j + i,
                                    -is_ * num_partition - j * np_)
                term = ctx.mult(babies[i], pt)
                T = term if T is None else ctx.add(T, term)
            T = self.rot.rotate(T, is_ * num_partition + j * np_)
            result = T if result is None else ctx.add(result, T)
        return result

    # ---------- rotationIndexCheckN (sort_algo.h:658-750) ----------
    def rotation_index_check_n(self, ctx_rank: Ciphertext,
                               input_array: Ciphertext) -> Ciphertext:
        N = self.N
        ctx = self.ctx
        num_partition = min(N, self.max_batch // N)
        num_batch = N // num_partition
        num_slots = num_partition * N
        np_ = min(_NP_CHECK[N], max(1, (num_slots // N)))

        index_pt = ctx.make_plaintext(self._index_vector(), ctx_rank.limbs,
                                      ctx_rank.scale, N)
        index_minus_rank = ctx.rsub(index_pt, ctx_rank).with_slots(num_slots)
        input_full = input_array.with_slots(num_slots)

        coeffs = doubled_sinc_coefficients(N)
        output = None
        for b in range(num_batch):
            chk = self._checking_vector_n(num_slots, b * num_partition)
            rot_index = ctx.sub(index_minus_rank,
                                self._pt_at(chk, index_minus_rank, num_slots))
            # range (-2N, N) -> (-1, 0.5)
            rot_index = ctx.mult_scalar(rot_index, 1.0 / N / 2.0)
            sinc_mask = eval_chebyshev_series_ps(ctx, rot_index, coeffs)
            masked = ctx.mult(sinc_mask, input_full)
            masked_rots = self._batch_rotate(masked, range(np_))
            rotated = self._blind_rotation_opt_n(
                masked_rots, num_slots, np_, b, num_partition)
            output = rotated if output is None else ctx.add(output, rotated)

        for i in range(1, int(np.log2(num_partition)) + 1):
            output = ctx.add(output, self.rot.rotate(output, num_slots >> i))
        return output.with_slots(N)

    def _pt_at(self, vec, ct, num_slots):
        """Plaintext at the ciphertext's exact scale (for subs from cts)."""
        return self.ctx.make_plaintext(vec, ct.limbs, ct.scale, num_slots)

    def _blind_rotation_opt_n(self, masked_inputs, num_slots, np_, ib,
                              num_partition):
        """(blindRotationOptN, sort_algo.h:561-584)."""
        ctx = self.ctx
        result = None
        groups = (num_slots // self.N) // np_
        for i in range(groups):
            tmp = None
            for j in range(np_):
                pt = self._pt_block(masked_inputs[j], num_slots, self.N,
                                    np_ * i + j, j)
                term = ctx.mult(masked_inputs[j], pt)
                tmp = term if tmp is None else ctx.add(tmp, term)
            tmp = self.rot.rotate(tmp, ib * num_partition + i * np_)
            result = tmp if result is None else ctx.add(result, tmp)
        return result

    # ---------- rotationIndexCheck2N (sort_algo.h:587-656) ----------
    def rotation_index_check_2n(self, ctx_rank: Ciphertext,
                                input_array: Ciphertext) -> Ciphertext:
        """Alternate permutation stage: plain scaled-sinc kernel over the
        doubled (-2N, 2N) index range with 2N-wide blind-rotation blocks
        (rotationIndexCheck2N, sort_algo.h:587-656).  Uses twice the slots
        per copy of checkN but the plain sinc series instead of the
        doubled one."""
        N = self.N
        ctx = self.ctx
        num_partition = min(2 * N, self.max_batch // N)
        num_batch = 2 * N // num_partition
        num_slots = num_partition * N
        # np = largest power of two with np^2 <= num_partition/2
        # (sort_algo.h:598-601)
        np_ = 1 << (int(np.log2(max(1, num_partition // 2))) >> 1)
        if np_ * np_ > num_partition // 2:
            np_ >>= 1
        np_ = max(1, np_)

        index_pt = ctx.make_plaintext(self._index_vector(), ctx_rank.limbs,
                                      ctx_rank.scale, N)
        index_minus_rank = ctx.rsub(index_pt, ctx_rank).with_slots(num_slots)
        input_full = input_array.with_slots(num_slots)

        coeffs = sinc_coefficients(N)
        output = None
        for b in range(num_batch):
            chk = self._checking_vector_2n(num_slots,
                                           b * (num_slots // N // 2))
            rot_index = ctx.sub(index_minus_rank,
                                self._pt_at(chk, index_minus_rank, num_slots))
            # range (-2N, 2N) -> (-1, 1)
            rot_index = ctx.mult_scalar(rot_index, 1.0 / N / 2.0)
            sinc_mask = eval_chebyshev_series_ps(ctx, rot_index, coeffs)
            masked = ctx.mult(sinc_mask, input_full)
            masked_rots = self._batch_rotate(
                masked, [b * (num_slots // N // 2) + i for i in range(np_)])
            rotated = self._blind_rotation_opt_2n(masked_rots, num_slots, np_)
            output = rotated if output is None else ctx.add(output, rotated)

        for i in range(1, int(np.log2(num_partition)) + 1):
            output = ctx.add(output, self.rot.rotate(output, num_slots >> i))
        return output.with_slots(N)

    def _blind_rotation_opt_2n(self, masked_inputs, num_slots, np_):
        """2N-wide-block variant (blindRotationOpt2N, sort_algo.h:536-559):
        the batch offset is pre-baked into masked_inputs' rotations, so the
        group rotation is i*np only."""
        ctx = self.ctx
        result = None
        groups = (num_slots // self.N // 2) // np_
        for i in range(groups):
            tmp = None
            for j in range(np_):
                pt = self._pt_block(masked_inputs[j], num_slots,
                                    2 * self.N, np_ * i + j, j)
                term = ctx.mult(masked_inputs[j], pt)
                tmp = term if tmp is None else ctx.add(tmp, term)
            tmp = self.rot.rotate(tmp, i * np_)
            result = tmp if result is None else ctx.add(result, tmp)
        return result

    # ---------------- sort (sort_algo.h:752-774) ----------------
    def sort(self, input_array: Ciphertext,
             cfg: SignConfig | None = None) -> Ciphertext:
        cfg = cfg or default_sign_config(self.N)
        rank = self.construct_rank(input_array, cfg)
        return self.rotation_index_check_n(rank, input_array)

    def sort_2n(self, input_array: Ciphertext,
                cfg: SignConfig | None = None) -> Ciphertext:
        """sort via the 2N permutation stage (the reference exposes it
        through DirectSortNTest, tests/DirectSortNTest.cpp:130-283)."""
        cfg = cfg or default_sign_config(self.N)
        rank = self.construct_rank(input_array, cfg)
        return self.rotation_index_check_2n(rank, input_array)

    # ============ hybrid variants (sort_algo.h:776-1389) ============
    # MEHP24-style oblivious permutation applied to the SIMD rank: the
    # rank vector is reinterpreted at N*N slots (each row holds the full
    # rank pattern), an indicator of (row - rank_j) selects matrix cell
    # (i, j) iff rank_j == i, the input is mask-multiplied in, and
    # column-sum + transpose ladders collapse the matrix to the sorted
    # vector.

    MAX_ARRAY_SIZE = 256        # sub-block width for N > 256

    def _hybrid_geometry(self):
        N = self.N
        if N > self.MAX_ARRAY_SIZE:
            return self.max_batch, N // self.MAX_ARRAY_SIZE
        return N * N, 1

    def _binary_path(self, index: int, matrix_size: int) -> list[int]:
        """MSB-first bits of index (getBinaryPath, sort_algo.h:815-821)."""
        bits = int(np.log2(matrix_size))
        return [(index >> i) & 1 for i in range(bits - 1, -1, -1)]

    def _ladder_rotate(self, c: Ciphertext, k: int) -> Ciphertext:
        """Hybrid-ladder rotation: dedicated single-hop key in registry
        mode (_gen_hybrid_keys), composed from the pow-2 ladder in
        minimal-key mode (where the composer's wrap is the physical
        period, so arbitrary indices recode correctly)."""
        if self.use_minimal_keys:
            return self.rot.rotate(c, k)
        return self.ctx.rotate(c, k)

    def sum_columns_to_target(self, c: Ciphertext, matrix_size: int,
                              column_index: int,
                              mask_output: bool) -> Ciphertext:
        """Log-ladder column sum landing on a chosen column
        (sumColumnsToTarget, sort_algo.h:824-859)."""
        ctx = self.ctx
        ns = matrix_size * matrix_size
        c = c.with_slots(ns)
        step = matrix_size >> 1
        for bit in self._binary_path(column_index, matrix_size):
            c = ctx.add(c, self._ladder_rotate(c, -step if bit else step))
            step >>= 1
        if mask_output:
            msk = np.zeros(ns)
            msk[column_index::matrix_size] = 1.0
            c = ctx.mult(c, self._pt(msk, c, ns))
        return c

    def transpose_column_target(self, c: Ciphertext, matrix_size: int,
                                row_index: int,
                                mask_output: bool) -> Ciphertext:
        """Column -> chosen row (transposeColumnTarget,
        sort_algo.h:861-891)."""
        ctx = self.ctx
        ns = matrix_size * matrix_size
        c = c.with_slots(ns)
        step = matrix_size * (matrix_size - 1) // 2
        for bit in self._binary_path(row_index, matrix_size):
            c = ctx.add(c, self._ladder_rotate(c, -step if bit else step))
            step >>= 1
        if mask_output:
            msk = np.zeros(ns)
            msk[matrix_size * row_index: matrix_size * (row_index + 1)] = 1.0
            c = ctx.mult(c, self._pt(msk, c, ns))
        return c

    def _hybrid_sub_mask(self, b: int, num_slots: int,
                         scaled: bool) -> np.ndarray:
        """subMasks[b][i*as + j] = (b*as + i) (/N if scaled)
        (sort_algo.h:918-927)."""
        asz = min(self.N, self.MAX_ARRAY_SIZE)
        rows = np.repeat(np.arange(asz, dtype=np.float64) + b * asz, asz)
        full = np.tile(rows, num_slots // (asz * asz))[:num_slots]
        return full / self.N if scaled else full

    def _gen_hybrid_keys(self):
        """Keys for exactly the ladder steps the hybrid stage performs:
        block b's ladders rotate by -step on 1-bits of b's path and +step
        on 0-bits, so only those signed steps need keys (a full +- set at
        depth 46 would be dozens of ~0.5 GiB keys).  In
        minimal-key mode no extra keys are generated at all: the ladder
        rotations compose from the pow-2 set via the binary decomposer."""
        if self.use_minimal_keys:
            return
        half = self.ctx.n // 2
        asz = min(self.N, self.MAX_ARRAY_SIZE)
        _, num_batch = self._hybrid_geometry()
        keys = set()
        for b in range(num_batch):
            step = asz >> 1
            for bit in self._binary_path(b, asz):
                keys.add((-step if bit else step) % half)
                step >>= 1
            step = asz * (asz - 1) // 2
            for bit in self._binary_path(b, asz):
                keys.add((-step if bit else step) % half)
                step >>= 1
            if b:
                keys.add((b * self.MAX_ARRAY_SIZE) % half)
        self.ctx.gen_rotation_keys(sorted(k for k in keys if k))

    def _rotation_index_check_hybrid_core(self, ctx_rank: Ciphertext,
                                          input_array: Ciphertext,
                                          kernel, sub_mask_fn) -> Ciphertext:
        """Shared skeleton of the three hybrid permutation stages
        (sort_algo.h:893-1048, 1067-1210, 1232-1373).  `kernel(diff)`
        maps the (index - rank) ciphertext to the 0/1 selection mask;
        `sub_mask_fn(b, num_slots)` builds the per-block row-index mask."""
        ctx = self.ctx
        self._gen_hybrid_keys()
        num_slots, num_batch = self._hybrid_geometry()
        asz = min(self.N, self.MAX_ARRAY_SIZE)

        r = ctx_rank.with_slots(num_slots)
        inp = input_array.with_slots(num_slots)
        rots_rank = [self._ladder_rotate(r, b * self.MAX_ARRAY_SIZE)
                     for b in range(num_batch)]
        rots_input = [self._ladder_rotate(inp, b * self.MAX_ARRAY_SIZE)
                      for b in range(num_batch)]

        result = None
        for b in range(num_batch):
            sub_masked = None
            for k in range(num_batch):
                diff = ctx.rsub(
                    self._pt_at(sub_mask_fn(b, num_slots),
                                rots_rank[k], num_slots), rots_rank[k])
                sel = kernel(diff)
                term = ctx.mult(rots_input[k], sel)
                sub_masked = term if sub_masked is None else \
                    ctx.add(sub_masked, term)
            sub_masked = self.sum_columns_to_target(sub_masked, asz, b, True)
            masked = self.transpose_column_target(sub_masked, asz, b, True)
            result = masked if result is None else ctx.add(result, masked)
        return result.with_slots(self.N)

    def rotation_index_check_hybrid(self, ctx_rank: Ciphertext,
                                    input_array: Ciphertext) -> Ciphertext:
        """sinc kernel for N < 256, indicator for larger
        (rotationIndexCheckHybrid, sort_algo.h:893-1048)."""
        ctx = self.ctx
        N = self.N
        r_scaled = ctx.mult_scalar(ctx_rank, 1.0 / N)

        if N < 256:
            coeffs = sinc_coefficients(N)

            def kernel(diff):
                return eval_chebyshev_series_ps(ctx, diff, coeffs)
        else:
            dg = 4 if N < 512 else 5
            cfg = SignConfig(CompositeSignConfig(3, dg, 2))

            def kernel(diff):
                return _indicator(ctx, diff, 0.5 / N, self.sign_func, cfg)
        return self._rotation_index_check_hybrid_core(
            r_scaled, input_array, kernel,
            lambda b, ns: self._hybrid_sub_mask(b, ns, True))

    def rotation_index_check_hybrid1(self, ctx_rank: Ciphertext,
                                     input_array: Ciphertext) -> Ciphertext:
        """mehp24 indicatorAdv with dg_i = (log2 N + 1)/2, df_i = 2
        (rotationIndexCheckHybrid1, sort_algo.h:1067-1210)."""
        ctx = self.ctx
        N = self.N
        dg_i = (int(np.log2(N)) + 1) // 2
        df_i = 2

        def kernel(diff):
            return _indicator_adv(ctx, diff, float(N), dg_i, df_i)
        return self._rotation_index_check_hybrid_core(
            ctx_rank, input_array, kernel,
            lambda b, ns: self._hybrid_sub_mask(b, ns, False))

    def rotation_index_check_hybrid2(self, ctx_rank: Ciphertext,
                                     input_array: Ciphertext) -> Ciphertext:
        """sinc Chebyshev at every size (rotationIndexCheckHybrid2,
        sort_algo.h:1232-1373)."""
        ctx = self.ctx
        N = self.N
        r_scaled = ctx.mult_scalar(ctx_rank, 1.0 / N)
        coeffs = sinc_coefficients(N)

        def kernel(diff):
            return eval_chebyshev_series_ps(ctx, diff, coeffs)
        return self._rotation_index_check_hybrid_core(
            r_scaled, input_array, kernel,
            lambda b, ns: self._hybrid_sub_mask(b, ns, True))

    def sort_hybrid(self, input_array: Ciphertext,
                    cfg: SignConfig | None = None) -> Ciphertext:
        """constructRank + MEHP24-style permutation (sort_algo.h:1051-1065)."""
        cfg = cfg or default_sign_config(self.N)
        rank = self.construct_rank(input_array, cfg)
        return self.rotation_index_check_hybrid(rank, input_array)

    def sort_hybrid1(self, input_array: Ciphertext,
                     cfg: SignConfig | None = None) -> Ciphertext:
        """(sort_algo.h:1214-1229)."""
        cfg = cfg or default_sign_config(self.N)
        rank = self.construct_rank(input_array, cfg)
        return self.rotation_index_check_hybrid1(rank, input_array)

    def sort_hybrid2(self, input_array: Ciphertext,
                     cfg: SignConfig | None = None) -> Ciphertext:
        """(sort_algo.h:1375-1389)."""
        cfg = cfg or default_sign_config(self.N)
        rank = self.construct_rank(input_array, cfg)
        return self.rotation_index_check_hybrid2(rank, input_array)
