"""One-card smoke test: the hybrid1 N=128 encrypted sort on an NVIDIA GPU.

    python chip_smoke.py                 # every phase, one card
    python chip_smoke.py --phases 1,3    # a subset (1 parity, 2 sort, 3 NTT)

Everything runs in this one process; it starts no other JAX process (the
`gpu`-marked tests run in process through pytest.main, and nvidia-smi is
the only child).  Phases:

  1  parity at real widths, all bit-exact (uint32 modular arithmetic):
     a) the XLA NTT, forward and inverse at n=2^17, on a non-prefix sample
        of the chain's rows (q and special primes) against the host numpy
        oracle (core/host_poly.py);
     b) _kj_mult_relin, _kj_rescale, _kj_rotate_fused and _kj_fast_rotate
        at the top limb bucket against the same jitted function run on the
        CPU device of this process;
     c) keys.gen_rotation_key_dev twice for one index: bit-identical keys
        (KeyStore eviction depends on it);
     d) the repository's `gpu`-marked tests.
  2  the main path: hybrid1 N=128 at ring 2^17, depth 46, HEStd-128-classic
     (registry.py), driven through bench.py: set-up, pretouch with per
     (kernel, bucket) compile seconds, one cold and two warm trials, each
     held to the reference's max-error gate (< 0.01), op census, peak
     device memory.
  3  the forward XLA NTT over the whole chain (q and special rows): time
     per limb-transform and its share of the device-memory bound.

Diagnostics go to earlier lines (details on stderr).  The last line of
stdout is one JSON object, {"ok": true, "device": {...}}, printed only when
every requested phase passed; otherwise, and when JAX finds no GPU, the
process exits nonzero without it.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import sorting_fhe_tpu  # noqa: E402,F401  (compile-cache side effect)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

ALGO, N, RING_LOG = "hybrid1", 128, 17
TRIALS = 3          # phase 2: one cold trial, two warm
PARITY_KERNELS = ("mult_relin", "rescale", "rotate_fused", "fast_rotate")


def say(msg):
    print(msg, flush=True)


def require_gpu():
    """Device 0 must be a GPU: the smoke measures nothing on a CPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (jax.devices()[0] is "
                         f"{dev.platform}: {dev.device_kind})")
    return dev


def card_line() -> str:
    """Name and power limit of the card, from nvidia-smi (a child process
    that does not touch JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


@contextlib.contextmanager
def no_persistent_cache_writes():
    """Keep CPU executables out of the persistent compilation cache: the
    XLA:CPU loader of this jaxlib segfaults when it reloads them."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    try:
        yield
    finally:
        jax.config.update(key, old)


# ------------------------------------------------------------ phase 1


def ntt_parity(ntt, rows, dev) -> list[str]:
    """Forward and inverse XLA NTT of random residues on chain `rows`
    against the host oracle; returns the mismatching rows."""
    from sorting_fhe_tpu.core.host_poly import host_ntt
    from sorting_fhe_tpu.core.ntt import ntt_fwd_t, ntt_inv_t

    sel = np.asarray(rows)
    n = ntt.n
    primes = [ntt.primes[r] for r in rows]
    rng = np.random.default_rng(1)
    x = np.stack([rng.integers(0, p, size=n, dtype=np.uint64)
                  for p in primes]).astype(np.uint32)
    put = lambda a: jax.device_put(a, dev)
    fwd = np.asarray(jax.jit(ntt_fwd_t)(
        put(x), put(ntt.p[sel]), put(ntt.psi[sel]), put(ntt.psi_sh[sel])))
    inv = np.asarray(jax.jit(ntt_inv_t)(
        put(x), put(ntt.p[sel]), put(ntt.ipsi[sel]), put(ntt.ipsi_sh[sel]),
        put(ntt.n_inv[sel]), put(ntt.n_inv_sh[sel])))
    bad = []
    for i, (r, p) in enumerate(zip(rows, primes)):
        h = host_ntt(p, n)
        if not np.array_equal(fwd[i].astype(np.uint64), h.fwd(x[i])):
            bad.append(f"fwd row {r}")
        if not np.array_equal(inv[i].astype(np.uint64), h.inv(x[i])):
            bad.append(f"inv row {r}")
    return bad


def random_ct(ctx, rows, rng):
    """[2, rows, n] uint32 residues, uniform below each row's prime."""
    q = ctx.params.q
    return jnp.asarray(np.stack([
        rng.integers(0, q[i], size=(2, ctx.n), dtype=np.uint64)
        for i in range(rows)], axis=1).astype(np.uint32))


def kernel_parity(ctx, ref_dev, limbs=None) -> dict:
    """Each PARITY_KERNELS kernel at the bucket of `limbs` (default: the
    whole chain) on the default device against the same jitted function on
    `ref_dev`.  The default-device calls take the evaluator's own argument
    path, so their executables are the ones the sort dispatches later.
    Returns {kernel: (bit_equal, first_call_s, ref_s)}."""
    from sorting_fhe_tpu.core import ckks as C

    l = ctx.bucket_limbs(limbs or ctx.params.nq)
    T = ctx.tables(l)
    rng = np.random.default_rng(2)
    a, b = random_ct(ctx, l, rng), random_ct(ctx, l, rng)
    kk = min(ctx.rot_keys)
    rk, perm = ctx.rot_keys[kk], ctx._perm(kk)
    pre = C._kj_decompose(a[1], T)
    cases = {
        "mult_relin": (C._kj_mult_relin, (a, b, ctx.relin_key, T)),
        "rescale": (C._kj_rescale, (a, ctx._rescale_consts(l), T)),
        "rotate_fused": (C._kj_rotate_fused, (a, rk, perm, T)),
        "fast_rotate": (C._kj_fast_rotate, (a, pre, rk, perm, T)),
    }
    out = {}
    for name in PARITY_KERNELS:
        fn, args = cases[name]
        t0 = time.time()
        got = fn(*args).block_until_ready()
        t_dev = time.time() - t0
        t0 = time.time()
        with no_persistent_cache_writes():
            want = fn(*jax.device_put(args, ref_dev)).block_until_ready()
        t_ref = time.time() - t0
        out[name] = (np.array_equal(np.asarray(got), np.asarray(want)),
                     t_dev, t_ref)
        del got, want
    return out


def keygen_parity(ctx, index: int = 3) -> bool:
    """gen_rotation_key_dev twice for one rotation index: bit-identical?"""
    from sorting_fhe_tpu.core.encoding import galois_element_for_rotation

    g = galois_element_for_rotation(ctx.n, index)
    k1 = ctx.keygen.gen_rotation_key_dev(g)
    k2 = ctx.keygen.gen_rotation_key_dev(g)
    return bool(jnp.array_equal(k1, k2))


class _Tally:
    """pytest plugin: counts test outcomes."""

    def __init__(self):
        self.counts = {"passed": 0, "failed": 0, "skipped": 0}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] += 1


def gpu_tests() -> dict:
    """The `gpu`-marked tests, in this process."""
    import pytest

    tally = _Tally()
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-o", "addopts=",
                      "-m", "gpu", os.path.join(HERE, "tests")],
                     plugins=[tally])
    return {"rc": int(rc), **tally.counts}


def phase_parity(ctx) -> bool:
    dev, cpu = jax.devices()[0], jax.devices("cpu")[0]
    P = ctx.params
    nq, ntot = P.nq, len(P.all_primes)
    # non-prefix sample: base primes, mid-chain and top q rows, special rows
    rows = [0, 2, nq // 2, nq - 2, nq - 1, nq, nq + (ntot - nq) // 2,
            ntot - 1]
    ok = True
    t0 = time.time()
    bad = ntt_parity(P.ntt, rows, dev)
    ok &= not bad
    say(f"[1a] NTT fwd+inv n=2^{RING_LOG} rows {rows} vs host oracle: "
        f"{'bit-exact' if not bad else 'MISMATCH ' + ', '.join(bad)} "
        f"({time.time() - t0:.1f}s)")
    res = kernel_parity(ctx, cpu)
    for name, (eq, t_dev, t_ref) in res.items():
        ok &= eq
        say(f"[1b] _kj_{name} at {ctx.bucket_limbs(nq)} rows: GPU vs CPU "
            f"{'bit-exact' if eq else 'MISMATCH'} (GPU first call incl. "
            f"compile {t_dev:.1f}s, CPU reference {t_ref:.1f}s)")
    t0 = time.time()
    same = keygen_parity(ctx)
    ok &= same
    say(f"[1c] gen_rotation_key_dev twice: "
        f"{'bit-identical' if same else 'DIFFERENT'} "
        f"({time.time() - t0:.1f}s)")
    t0 = time.time()
    tests = gpu_tests()
    tests_ok = (tests["rc"] == 0 and tests["passed"] > 0
                and not tests["skipped"])
    ok &= tests_ok
    say(f"[1d] gpu-marked tests: {tests} ({time.time() - t0:.1f}s)")
    return ok


# ------------------------------------------------------------ phase 2


def phase_sort(s, trials: int, card: str) -> bool:
    import bench

    r = bench.run_sort(s, trials)
    for lb in sorted({b for _, b in r["compile_s"]}, reverse=True):
        ks = "  ".join(f"{k}={v:.1f}" for (k, b), v in
                       sorted(r["compile_s"].items()) if b == lb)
        say(f"[2] compile s, bucket {lb}: {ks}")
    say(f"[2] set-up s: context={s['context_s']:.1f} keys={s['keys_s']:.1f}"
        f" pretouch={r['pretouch_s']:.1f} encrypt={r['encrypt_s']:.1f}")
    for t, (dt, err, census) in enumerate(zip(r["trials"], r["max_errs"],
                                              r["census"])):
        say(f"[2] trial {t} ({'cold' if t == 0 else 'warm'}): {dt:.3f}s "
            f"max_err={err:.3e} (log2 {np.log2(max(err, 1e-300)):.2f}) "
            f"census={census}")
    limit = jax.devices()[0].memory_stats().get("bytes_limit")
    say(f"[2] peak_bytes_in_use={r['device_mem']['peak_bytes_in_use']} "
        f"bytes_limit={limit} on {card}")
    say(f"[2] error gate < {bench.ERR_GATE} on every trial: "
        f"{'pass' if r['gate_ok'] else 'FAIL'}")
    return r["gate_ok"]


# ------------------------------------------------------------ phase 3


def phase_ntt(ctx, card: str) -> bool:
    import bench

    rec = bench.ntt_bench(ctx.params.ntt)
    say(f"[3] XLA forward NTT, {rec['rows']} rows x 2^{RING_LOG}: "
        f"{rec['per_limb_us']:.3f} us per limb-transform "
        f"(best of {len(rec['times_s'])}; bound {rec['bound_per_limb_us']:.3f}"
        f" us = 16n bytes at peak bandwidth) -> bandwidth share "
        f"{rec['bandwidth_share']:.4f} on {card}")
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3",
                    help="comma-separated subset of 1,2,3")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}

    dev = require_gpu()
    card = card_line()
    say(f"[card] {card}")
    say(f"[jax] {jax.__version__}; devices {len(jax.devices())} x "
        f"{dev.device_kind}")
    say(f"[xla] XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
        f"compilation cache "
        f"{jax.config.jax_compilation_cache_dir!r}")

    import bench

    results = {}
    try:
        s = bench.setup_sort(ALGO, N, RING_LOG)
    except Exception:
        traceback.print_exc()
        say("[setup] FAILED")
        return 1
    ctx = s["ctx"]
    say(f"[setup] {ctx.params.describe()}; security logQP="
        f"{s['security_logqp']} limit={s['security_limit']} "
        f"ok={s['security_ok']}; context {s['context_s']:.1f}s, "
        f"{s['key_mode']} rotation keys {s['keys_s']:.1f}s")
    results["security"] = bool(s["security_ok"])
    for p, fn in ((1, lambda: phase_parity(ctx)),
                  (2, lambda: phase_sort(s, TRIALS, card)),
                  (3, lambda: phase_ntt(ctx, card))):
        if p not in phases:
            continue
        t0 = time.time()
        try:
            results[p] = bool(fn())
        except Exception:
            traceback.print_exc()
            results[p] = False
        say(f"[phase {p}] {'pass' if results[p] else 'FAIL'} "
            f"({time.time() - t0:.1f}s)")
    if not all(results.values()):
        say(f"[smoke] FAILED: {results}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
