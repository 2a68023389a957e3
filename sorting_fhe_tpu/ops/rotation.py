"""Rotation machinery: decomposition of arbitrary rotations into available
key steps, composition, and hoisting-aware caching.

Rebuild of /root/reference/src/rotation.h:
  Decomposer        — Binary / NAF / block-NAF digit recoding over the
                      available rotation-key index set (rotation.h:28-166)
  RotationComposer  — single-key fast path, else composed sequence
                      (rotation.h:193-238)
  RotationTree      — trie of decomposition prefixes caching intermediate
                      rotated ciphertexts, with hoisted fast rotations at
                      shared nodes (rotation.h:240-358)

Every rotation already uses the hoisted path (one decomposition per
source ciphertext, shared across rotations — ckks.fast_rotation), so the
tree's win is caching intermediate *rotated ciphertexts* across calls.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass

from ..core.ckks import CkksContext, Ciphertext


class DecomposeAlgo(enum.Enum):
    NAF = 0
    BNAF = 1
    BINARY = 2


@dataclass
class Step:
    value: int      # -1, 0, or 1 (sign); binary uses 1 only
    step_size: int  # signed rotation amount contributed

    @property
    def rotation(self) -> int:
        return self.step_size


class Decomposer:
    """Decomposes a rotation into steps available in the key set."""

    def __init__(self, rot_indices: list[int], wrap: int):
        self.rot_indices = sorted(rot_indices)
        self.wrap = wrap       # N: template parameter of the reference
        self.max_decomposed = self._calculate_max()

    def _calculate_max(self) -> int:
        out = 0
        step = 1
        for idx in self.rot_indices:
            if step == idx // 2:
                out += idx
            step = idx
        return out

    def decompose(self, rotation: int, wrap_n: int,
                  algo: DecomposeAlgo) -> list[Step]:
        original = rotation
        steps: list[Step] = []
        if not self.rot_indices:
            return [Step(1, rotation)]
        largest = self.rot_indices[-1]
        while rotation >= largest:
            steps.append(Step(1, largest))
            rotation -= largest
        if rotation > 0:
            while rotation > self.max_decomposed:
                import bisect
                i = bisect.bisect_left(self.rot_indices, rotation)
                legal = self.rot_indices[max(0, i - 1)]
                steps.append(Step(1, legal))
                rotation -= legal
        if rotation > 0:
            if algo == DecomposeAlgo.NAF:
                steps.extend(self._naf(rotation))
            elif algo == DecomposeAlgo.BNAF:
                steps.extend(self._bnaf(rotation))
            else:
                steps.extend(self._binary(rotation))
        # decomposition must reproduce the rotation modulo the slot wrap
        # (the binary recoder only emits bits below self.wrap — catch any
        # rotation that silently lost high bits rather than mis-rotate).
        # NAF's -wrap/2 -> +wrap/2 flip shifts the total by self.wrap, so
        # equivalence holds mod gcd(self.wrap, wrap_n).
        total = sum(s.step_size for s in steps)
        mod = math.gcd(self.wrap, wrap_n)
        assert (total - original) % mod == 0, \
            f"cannot decompose rotation {original} over keys " \
            f"{self.rot_indices} (wrap {wrap_n})"
        # drop steps that are no-ops modulo the slot wrap
        return [s for s in steps if s.step_size % wrap_n != 0]

    def _binary(self, rotation: int) -> list[Step]:
        out = []
        for i in range(31, -1, -1):
            sz = 1 << i
            if sz < self.wrap and rotation & sz:
                out.append(Step(1, sz))
        return out

    def _naf(self, rotation: int) -> list[Step]:
        out = []
        i = 0
        while rotation != 0:
            if rotation & 1:
                z = -1 if (rotation & 2) else 1
                sz = z * (1 << i)
                if sz == -self.wrap // 2:
                    out.append(Step(-z, -sz))
                else:
                    out.append(Step(z, sz))
                rotation -= z
            rotation >>= 1
            i += 1
        return out[::-1]

    def _bnaf(self, k: int) -> list[Step]:
        digits = []
        K = k
        B = 2
        while K != 0:
            ki = K % B
            K = (K - ki) // B
            if ki > B // 2 or (ki == B // 2 and (K % B) >= B // 2):
                ki -= B
                K += 1
            digits.append(ki)
        out = [Step(d, d << i) for i, d in enumerate(digits) if d != 0]
        return out[::-1]


@dataclass
class RotationStats:
    """Operation counters (reference rotation.h:168-191: fast / normal /
    total rotations plus tree-cache hits and misses)."""
    fast_rotations: int = 0        # single-key path
    normal_rotations: int = 0     # key-switches spent composing
    cache_hits: int = 0
    cache_misses: int = 0

    @property
    def total_rotations(self) -> int:
        return self.fast_rotations + self.normal_rotations

    def reset(self):
        self.fast_rotations = 0
        self.normal_rotations = 0
        self.cache_hits = 0
        self.cache_misses = 0

    def report(self) -> str:
        return (f"rotations: fast={self.fast_rotations} "
                f"composed-steps={self.normal_rotations} "
                f"total={self.total_rotations} "
                f"cache: hits={self.cache_hits} misses={self.cache_misses}")


class RotationComposer:
    """rotate(ct, k): single key if available, else composed steps.
    (reference rotation.h:215-233; here every step is a hoisted fast
    rotation and the decomposition of the source ct is shared)."""

    def __init__(self, ctx: CkksContext, rot_indices: list[int], wrap: int,
                 algo: DecomposeAlgo = DecomposeAlgo.BINARY):
        self.ctx = ctx
        self.decomposer = Decomposer(rot_indices, wrap)
        self.algo = algo
        self.available = set(rot_indices)
        self.wrap = wrap
        self.stats = RotationStats()

    def rotate(self, ct: Ciphertext, rotation: int) -> Ciphertext:
        if rotation % ct.slots == 0:
            return ct
        half = self.ctx.n // 2
        # single-key fast path: an exact key for this index (incl. keys
        # registered on the context after construction, e.g. hybrid-stage
        # or negative-step keys)
        if rotation in self.available or rotation % half in self.available \
                or rotation % half in getattr(self.ctx, "rot_keys", {}):
            self.stats.fast_rotations += 1
            return self.ctx.rotate(ct, rotation)
        # composed path: normalize into the slot period first — a negative
        # rotation of an s-periodic vector equals rotation by (r mod s)
        r = rotation % ct.slots
        steps = self.decomposer.decompose(r, ct.slots, self.algo)
        out = ct
        for s in steps:
            self.stats.normal_rotations += 1
            out = self.ctx.rotate(out, s.step_size)
        return out


class RotationTree:
    """Caches rotated ciphertexts along shared decomposition prefixes,
    with one hoisting precompute per tree node (rotation.h:240-358)."""

    def __init__(self, ctx: CkksContext, rot_indices: list[int], wrap: int,
                 algo: DecomposeAlgo = DecomposeAlgo.NAF):
        self.ctx = ctx
        self.decomposer = Decomposer(rot_indices, wrap)
        self.algo = algo
        self.stats = RotationStats()

    def attach(self, ct: Ciphertext):
        """Begin a batch of rotations of the same source ciphertext."""
        self._root_ct = ct
        self._root_pre = None
        self._cache: dict[tuple, tuple] = {}   # prefix -> (ct, precomp|None)

    def rotate(self, rotation: int) -> Ciphertext:
        ct = self._root_ct
        if rotation % ct.slots == 0:
            return ct
        steps = self.decomposer.decompose(rotation, ct.slots, self.algo)
        prefix = ()
        cur = ct
        for s in steps:
            if s.value == 0:
                continue
            prefix = prefix + (s.step_size,)
            hit = self._cache.get(prefix)
            if hit is not None:
                self.stats.cache_hits += 1
                cur = hit[0]
                continue
            self.stats.cache_misses += 1
            parent_prefix = prefix[:-1]
            if parent_prefix == ():
                if self._root_pre is None:
                    self._root_pre = self.ctx.fast_rotation_precompute(cur)
                pre = self._root_pre
            else:
                pct, ppre = self._cache[parent_prefix]
                if ppre is None:
                    ppre = self.ctx.fast_rotation_precompute(pct)
                    self._cache[parent_prefix] = (pct, ppre)
                pre = ppre
            nxt = self.ctx.fast_rotation(cur, s.step_size, pre)
            self.stats.fast_rotations += 1
            self._cache[prefix] = (nxt, None)
            cur = nxt
        return cur
