"""GPU benchmark: encrypted sort wall-clock vs the reference baseline.

Run on the card (`python bench.py`).  Prints ONE JSON line on stdout:

    {"metric": ..., "value": <seconds>, "unit": "s", "vs_baseline": <r>, ...}

vs_baseline = ours / reference  (< 1.0 means faster than the baseline).
Baseline numbers are the reference's own recorded experiments
(/root/reference/comparison/experimental_results/ours_hybrid1/total_results.txt,
summarised in BASELINE.md): hybrid1 encrypted sort, OpenFHE ring 2^17,
HEStd_128_classic, avg of 10 trials.

All diagnostics (per-phase timing, memory, error) go to stderr so the
stdout contract stays one line.  The process fails (exit 1) when there is
no GPU, when a requested phase fails, or when a trial misses the error gate.

Env knobs:
  BENCH_ALGO    sort pipeline (default hybrid1; hybrid/hybrid2/direct/
                bitonic/kway/mehp24)
  BENCH_N       array size    (default 128 — the north-star size)
  BENCH_RING    log2 ring dim (default 17 — the reference's full-fidelity ring)
  BENCH_TRIALS  timed trials  (default 2; the first includes compiles)
  BENCH_SORT    set 0 to skip the sort and emit the NTT metric instead
  BENCH_NTT     set 1 to ALSO run the NTT timing (default off)
  BENCH_MICRO   set 1 to ALSO run the per-op micro table (default off)
  BENCH_PROFILE directory: trace the last trial with jax.profiler
"""

import json
import os
import sys
import time

import numpy as np

# Import the package FIRST: its __init__ points the persistent compilation
# cache at a fixed directory before anything below compiles.
import sorting_fhe_tpu  # noqa: F401  (cache side effect)
import jax

from sorting_fhe_tpu.utils.memory import device_mem_bytes

# Reference hybrid1 averages (BASELINE.md table; seconds)
BASELINE_HYBRID1 = {4: 26.69, 8: 36.25, 16: 37.03, 32: 52.14, 64: 56.93,
                    128: 74.12, 256: 93.53, 512: 178.87, 1024: 406.93}

# Device-memory bandwidth by jax device_kind, bytes/s (NVIDIA H100 SXM data
# sheet: 3.35 TB/s).  A device that is not listed is an error, not a
# default.
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}

ERR_GATE = 0.01     # the reference's max-error gate (BASELINE.md)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def require_gpu():
    """The benchmark measures the card; a CPU-only process is an error."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: jax.devices()[0] is {dev.platform} "
                         f"({dev.device_kind})")
    return dev


def ntt_bench(ntt, reps: int = 5) -> dict:
    """Forward XLA NTT over every row of `ntt` (an NttContext): time per
    limb-transform and its share of the device-memory bound.

    The bound moves 16*n bytes per limb: read and write the data, read the
    twiddle and its Shoup companion."""
    from sorting_fhe_tpu.core.ntt import ntt_fwd_t

    dev = jax.devices()[0]
    bw = PEAK_BYTES_PER_S[dev.device_kind]
    L, n = len(ntt.primes), ntt.n
    rng = np.random.default_rng(0)
    x = jax.device_put(np.stack([
        rng.integers(0, p, size=n, dtype=np.uint64).astype(np.uint32)
        for p in ntt.primes]), dev)
    # tables as ARGUMENTS: closing over them would embed ~250 MB of
    # twiddle literals in the program
    f = jax.jit(ntt_fwd_t)
    t0 = time.time()
    f(x, ntt.p, ntt.psi, ntt.psi_sh).block_until_ready()
    compile_s = time.time() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        f(x, ntt.p, ntt.psi, ntt.psi_sh).block_until_ready()
        times.append(time.perf_counter() - t0)
    best = min(times)
    per_limb = best / L
    bound = 16 * n / bw
    rec = {"rows": L, "n": n, "compile_s": compile_s,
           "times_s": times, "per_limb_us": per_limb * 1e6,
           "bound_per_limb_us": bound * 1e6,
           "bandwidth_share": bound / per_limb,
           "device_kind": dev.device_kind}
    log(f"[ntt] {L} rows x 2^{n.bit_length() - 1}: best {best * 1e3:.3f} ms "
        f"per transform, {per_limb * 1e6:.3f} us per limb vs bound "
        f"{bound * 1e6:.3f} us -> share {bound / per_limb:.4f} "
        f"(compile {compile_s:.1f}s)")
    return rec


def micro_bench(ctx, limbs=None):
    """Device-side per-op ms table at the context's top level: mult+relin,
    rescale, hoisted-vs-composed rotation sweep (the reference's
    RotationBenchmark.cpp:8-53), and the plain sinc microbench
    (SincBenchmark.cpp:15-35).  Uses fori_loop rep differencing so the
    per-dispatch host overhead cancels."""
    import jax.numpy as jnp
    from jax import lax
    from sorting_fhe_tpu.core import ckks as C

    P = ctx.params
    l = limbs or P.nq
    T = ctx.tables(l)
    ctx.gen_rotation_keys([1])
    rk = ctx.rot_keys[1]
    perm = ctx._perm(1)
    rng = np.random.default_rng(0)
    data = jnp.asarray(np.stack([
        rng.integers(0, P.q[i], size=(2, ctx.n), dtype=np.int64
                     ).astype(np.uint32) for i in range(l)], axis=1))

    def marginal(make_body, lo=2, hi=8):
        fs = {}
        for K in (lo, hi):
            body = make_body()
            fs[K] = jax.jit(lambda a, K=K, body=body: lax.fori_loop(
                0, K, lambda i, x: body(x), a))
            fs[K](data).block_until_ready()
        ts = {}
        for K, f in fs.items():
            t0 = time.time()
            f(data).block_until_ready()
            ts[K] = time.time() - t0
        return (ts[hi] - ts[lo]) / (hi - lo)

    out = {}
    out["mult_relin_ms"] = marginal(
        lambda: lambda a: C._kj_mult_relin(a, a, ctx.relin_key, T)) * 1e3
    out["rescale_ms"] = marginal(
        lambda: lambda a: jnp.concatenate(
            [C._kj_rescale(a, ctx._rescale_consts(l), T)[:, :l - P.comp],
             jnp.zeros((2, P.comp, ctx.n), jnp.uint32)], axis=1)) * 1e3
    out["hoist_precompute_ms"] = marginal(
        lambda: lambda a: a.at[0].set(
            C._kj_decompose(a[1], T)[0, :l])) * 1e3

    def rot_chain(m, hoisted):
        def body(a):
            if hoisted:
                pre = C._kj_decompose(a[1], T)
                for _ in range(m):
                    a = C._kj_fast_rotate(a, pre, rk, perm, T)
            else:
                for _ in range(m):
                    pre = C._kj_decompose(a[1], T)
                    a = C._kj_fast_rotate(a, pre, rk, perm, T)
            return a
        return body

    # step sweep mirrors RotationBenchmark.cpp:8-53 (1..14 composed steps
    # vs hoisted); trimmed to 2 points because each m-step chain body is a
    # separate compile at ring 2^17
    for m in (1, 4):
        out[f"rot_composed_{m}_ms"] = marginal(
            lambda m=m: rot_chain(m, False), lo=1, hi=3) * 1e3
        out[f"rot_hoisted_{m}_ms"] = marginal(
            lambda m=m: rot_chain(m, True), lo=1, hi=3) * 1e3

    # plain sinc kernels (SincBenchmark.cpp:15-35) — host math throughput
    from sorting_fhe_tpu.ops.comparison import Sinc
    sk = Sinc(128)
    xs = np.linspace(-1, 1, 1 << 12)
    t0 = time.time()
    for x in xs:
        sk.scaled_sinc(x)
        sk.doubled_sinc(x)
    out["sinc_host_ns_per_eval"] = (time.time() - t0) / (2 * len(xs)) * 1e9

    log(f"[micro] limbs={l}: " + "  ".join(
        f"{k}={v:.2f}" for k, v in out.items()))
    return {k: round(v, 3) for k, v in out.items()}


def setup_sort(algo: str, N: int, ring_log: int) -> dict:
    """Context, keys and sorter for one (algo, N) at ring 2^ring_log.

    Returns a dict with the context, the sorter callable, the sign config
    and the set-up seconds; pretouch and trials are run_sort's."""
    from sorting_fhe_tpu.core.ckks import CkksContext
    from sorting_fhe_tpu.models.direct_sort import DirectSort
    from sorting_fhe_tpu.registry import (get_params, full_config,
                                          security_check)

    p = get_params(algo, N)
    # bitonic/k-way bootstrap mid-sort: sparse secret for EvalMod's sine
    # range (core/bootstrap.py default_K)
    boot = {"secret_hw": 64} if algo in ("bitonic", "kway") else {}
    if algo == "mehp24" and ring_log >= 16 and N >= 32:
        # mehp24's key set outgrows device memory: LRU + on-demand regen
        boot.setdefault("rot_key_budget_mb", int(os.environ.get(
            "SORTING_FHE_KEY_BUDGET_MB", "5120")))
    cfg = full_config(p, ring_dim=1 << ring_log, **boot)
    t0 = time.time()
    ctx = CkksContext(cfg)
    context_s = time.time() - t0
    logqp, limit, ok = security_check(cfg, ctx.params)
    log(f"[setup] context {context_s:.1f}s: {ctx.params.describe()} "
        f"limb_pad={cfg.limb_pad}")
    log(f"[setup] security logQP={logqp} HEStd-128c-limit={limit} ok={ok}")

    # key mode: at N >= 32 the default composes every rotation from the
    # power-of-two ladder (minimal keys, ~0.5 GB each at depth 46) instead
    # of the registry's single-hop set; whether the single-hop set fits
    # the card beside the working set is not measured yet
    minimal = os.environ.get("BENCH_KEYS", "minimal" if N >= 32
                             else "registry") == "minimal"
    t0 = time.time()
    direct_algos = {"direct", "hybrid", "hybrid1", "hybrid2"}
    if algo in direct_algos:
        ds = DirectSort(ctx, N, rot_indices=list(p.rotations),
                        use_minimal_keys=minimal)
        sort_fn = {"direct": ds.sort, "hybrid": ds.sort_hybrid,
                   "hybrid1": ds.sort_hybrid1,
                   "hybrid2": ds.sort_hybrid2}[algo]
    elif algo == "bitonic":
        from sorting_fhe_tpu.models.bitonic import BitonicSort
        from sorting_fhe_tpu.core.bootstrap import BootstrapHook
        ds = BitonicSort(ctx, N, bootstrap_level=29,
                         bootstrap_hook=BootstrapHook(ctx))
        sort_fn = ds.sort
    elif algo == "kway":
        from sorting_fhe_tpu.models.kway import KWaySorter
        from sorting_fhe_tpu.core.bootstrap import BootstrapHook
        k = int(os.environ.get("BENCH_KWAY_K", "2"))
        M = round(np.log(N) / np.log(k))
        assert k ** M == N, f"N={N} is not a power of k={k}"
        ds = KWaySorter(ctx, k, M, bootstrap_hook=BootstrapHook(ctx))
        sort_fn = ds.sort
    elif algo == "mehp24":
        from sorting_fhe_tpu.models import mehp24 as M24
        dg = {4: 2, 8: 2, 16: 3}.get(N, 3)
        sort_fn = lambda ct, cfg_sign: M24.sort_fg(
            ctx, ct, N, dg, 2, dg, 2)
    else:
        raise KeyError(f"unknown BENCH_ALGO {algo!r}")
    keys_s = time.time() - t0
    key_mode = "minimal" if minimal and algo in direct_algos else "registry"
    log(f"[setup] rotation keys ({len(ctx.rot_keys)}, {key_mode}) "
        f"{keys_s:.1f}s")
    return {"algo": algo, "N": N, "ring_log": ring_log, "ctx": ctx,
            "sort_fn": sort_fn, "sign": p.sign_config(),
            "context_s": context_s, "keys_s": keys_s, "key_mode": key_mode,
            "security_logqp": logqp, "security_limit": limit,
            "security_ok": ok}


def run_sort(s: dict, trials: int) -> dict:
    """Pretouch every (kernel, bucket), then `trials` timed sorts of one
    seeded vector; every trial is decrypted and held to ERR_GATE."""
    from sorting_fhe_tpu.utils.pretouch import pretouch
    from sorting_fhe_tpu.utils.testvec import vector_with_min_diff

    ctx, algo, N = s["ctx"], s["algo"], s["N"]
    pretouch_s, compile_s = pretouch(ctx, log=log)
    log(f"[pretouch] all buckets warm in {pretouch_s:.1f}s")
    rng = np.random.default_rng(42)
    v = vector_with_min_diff(N, 0, 1, 1.0 / N, rng)
    t0 = time.time()
    # mehp24 packs an NxN matrix; cap at 256x256 (the large-array split
    # tier, mirroring experiments.py) so slots never exceed n/2
    slots = min(N * N, 256 * 256, ctx.n // 2) if algo == "mehp24" else N
    ct = ctx.encrypt(v, slots=slots)
    encrypt_s = time.time() - t0
    log(f"[setup] encrypt {encrypt_s:.1f}s")

    profile_dir = os.environ.get("BENCH_PROFILE")
    times, errs, census = [], [], []
    for t in range(trials):
        prof = bool(profile_dir) and t == trials - 1
        if prof:
            jax.profiler.start_trace(profile_dir)
        t0 = time.time()
        out = s["sort_fn"](ct, s["sign"])
        out.data.block_until_ready()
        dt = time.time() - t0
        if prof:
            jax.profiler.stop_trace()
            log(f"[profile] trace written to {profile_dir}")
        times.append(dt)
        census.append(dict(ctx.op_counts))
        got = ctx.decrypt(out)[:N]
        err = float(np.abs(got - np.sort(v)).max())
        errs.append(err)
        log(f"[sort] trial {t}: {dt:.3f}s  max_err={err:.3e} "
            f"(log2={np.log2(max(err, 1e-300)):.2f}; gate {ERR_GATE}) "
            f"pt_encode={ctx.pt_encode_s:.1f}s/{ctx.pt_encode_count} "
            f"key_regens={getattr(ctx.rot_keys, 'regen_count', 0)}")
        log(f"[sort] op census: {census[-1]}")
        ctx.op_counts.clear()
        ctx.pt_encode_s = 0.0
        ctx.pt_encode_count = 0
    mem = device_mem_bytes()
    log(f"[sort] device memory {mem}")
    return {"trials": times, "max_errs": errs, "census": census,
            "pretouch_s": pretouch_s, "compile_s": compile_s,
            "encrypt_s": encrypt_s, "device_mem": mem,
            "gate_ok": all(e < ERR_GATE for e in errs)}


def sort_bench(algo: str, N: int, ring_log: int, trials: int) -> dict:
    s = setup_sort(algo, N, ring_log)
    r = run_sort(s, trials)
    warm = r["trials"][1:] or r["trials"]
    best = min(warm)
    base = BASELINE_HYBRID1.get(N) if algo == "hybrid1" else None
    rec = {"metric": f"encrypted_sort_{algo}_N{N}_ring2e{ring_log}",
           "value": round(best, 3), "unit": "s",
           "vs_baseline": round(best / base, 4) if base else None,
           "baseline_s": base, "max_err": max(r["max_errs"]),
           "gate_ok": r["gate_ok"],
           "trials": [round(x, 3) for x in r["trials"]],
           "setup_s": {"context": round(s["context_s"], 1),
                       "keys": round(s["keys_s"], 1),
                       "pretouch": round(r["pretouch_s"], 1),
                       "encrypt": round(r["encrypt_s"], 1)},
           "security_logqp": s["security_logqp"],
           "security_ok": s["security_ok"],
           "device_mem": r["device_mem"]}
    if os.environ.get("BENCH_MICRO", "0") == "1":
        # diagnostics AFTER the headline number is in hand
        rec["micro"] = micro_bench(s["ctx"])
    return rec


def main():
    dev = require_gpu()
    algo = os.environ.get("BENCH_ALGO", "hybrid1")
    N = int(os.environ.get("BENCH_N", "128"))
    ring_log = int(os.environ.get("BENCH_RING", "17"))
    trials = int(os.environ.get("BENCH_TRIALS", "2"))
    log(f"[bench] device={dev.device_kind} x{len(jax.devices())} "
        f"algo={algo} N={N} ring=2^{ring_log} trials={trials}")

    rec = None
    if os.environ.get("BENCH_SORT", "1") != "0":
        rec = sort_bench(algo, N, ring_log, trials)
    if os.environ.get("BENCH_NTT", "0") == "1" or rec is None:
        from sorting_fhe_tpu.core.params import CkksParams
        from sorting_fhe_tpu.registry import get_params, full_config
        P = CkksParams(full_config(get_params(algo, N),
                                   ring_dim=1 << ring_log))
        ntt = ntt_bench(P.ntt)
        if rec is None:
            rec = {"metric": f"ntt_per_limb_us_ring2e{ring_log}",
                   "value": ntt["per_limb_us"], "unit": "us",
                   "vs_baseline": None}
        rec["ntt"] = ntt
    rec["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                     "count": len(jax.devices())}
    print(json.dumps(rec))
    if not rec.get("gate_ok", True):
        sys.exit(1)


if __name__ == "__main__":
    main()
