"""Debug/test helpers that require the secret key.

`recrypt_hook` is the test-tier stand-in for EvalBootstrap: decrypt with
the secret key and re-encrypt fresh.  The reference's test strategy runs
real bootstrapping inside its k-way/bitonic tests (tests/KWaySortTest.cpp:44-45);
the cheap deep-network tests here exercise the *boot-triggering logic* with
this hook (the real EvalBootstrap, core/bootstrap.py, has its own tests) —
the trigger placement, level accounting, and post-boot scales are
identical, only the noise-refresh mechanism is swapped.  Never available without the secret
(mirrors DebugEncryption, /root/reference/src/encryption.h:56-93).
"""

from __future__ import annotations

import numpy as np


def recrypt_hook(ctx, fresh_levels: int | None = None):
    """Returns bootstrap_hook(ct) -> fresh ct holding the same values.

    fresh_levels: limb count to re-encrypt at (default: full tower)."""

    def hook(ct):
        vals = ctx.decrypt(ct)[: ct.slots]
        vals = np.real(np.asarray(vals))
        out = ctx.encrypt(vals, slots=ct.slots)
        if fresh_levels is not None:
            out = ctx.level_reduce(out, fresh_levels)
        return out

    return hook


def print_ct(ctx, ct, count: int = 8, label: str = ""):
    """PRINT_PT equivalent (encryption.h:34-54): decrypt-and-print."""
    v = ctx.decrypt(ct)[:count]
    print(f"[{label}] {np.array2string(np.asarray(v), precision=5)}")
