"""EvalBootstrap at full fidelity (ring 2^17).

Runs the REAL Bootstrapper (dense-LT CoeffsToSlots/SlotsToCoeffs +
sine EvalMod, core/bootstrap.py) standalone at the ring-2^17 tier that
bitonic/k-way full-fidelity sorts depend on
(/root/reference/src/sort_algo.h:1436-1438, k-way/EvalUtils.cpp:57-94),
and prints warm wall time, key-material budget, and output precision as
one JSON line on stdout (per-trial progress on stderr).

    python tools/bootstrap_proof.py [slots] [depth]

Defaults: slots=128, depth=52 (the registry's full-tier bitonic chain).
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import sorting_fhe_tpu  # noqa: F401  (persistent-cache side effect)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    from sorting_fhe_tpu.core.ckks import CkksContext
    from sorting_fhe_tpu.core.bootstrap import Bootstrapper
    from sorting_fhe_tpu.registry import (get_params, full_config,
                                          security_check)

    slots = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    depth = int(sys.argv[2]) if len(sys.argv) > 2 else None
    p = get_params("bitonic", max(4, min(slots, 1024)))
    over = {"secret_hw": 64,
            "rot_key_budget_mb": int(os.environ.get(
                "SORTING_FHE_KEY_BUDGET_MB", "5120"))}
    if depth:
        over["mult_depth"] = depth
    cfg = full_config(p, ring_dim=1 << 17, **over)

    t0 = time.time()
    ctx = CkksContext(cfg)
    t_ctx = time.time() - t0
    logqp, limit, ok = security_check(cfg, ctx.params)
    log(f"[setup] context {t_ctx:.1f}s {ctx.params.describe()} "
        f"logQP={logqp} limit={limit} ok={ok}")

    t0 = time.time()
    bs = Bootstrapper(ctx, slots).setup_keys()
    nkeys = len(ctx.rot_keys)
    t_keys = time.time() - t0
    key_bytes = int(np.prod(ctx.relin_key.shape)) * 4
    log(f"[setup] bootstrapper keys {t_keys:.1f}s: {nkeys} rotation "
        f"indices (key {key_bytes/1e9:.2f} GB each; budget "
        f"{cfg.rot_key_budget_mb} MB resident) sine_deg={bs._sine_deg} "
        f"K={bs.K} raise_limbs={bs.raise_limbs}")

    from sorting_fhe_tpu.utils.pretouch import pretouch
    log(f"[pretouch] {pretouch(ctx, log=log)[0]:.1f}s")

    rng = np.random.default_rng(5)
    v = rng.uniform(0.05, 0.95, slots)
    ct = ctx.encrypt(v, slots=slots)
    # deplete to near the bottom of the chain (the bitonic trigger state)
    ct = ctx.level_reduce(ct, bs.raise_limbs)

    times = []
    errs = []
    for trial in range(3):
        t0 = time.time()
        out = bs.bootstrap(ct)
        out.data.block_until_ready()
        dt = time.time() - t0
        got = ctx.decrypt(out)[:slots]
        err = float(np.abs(got - v).max())
        times.append(round(dt, 2))
        errs.append(err)
        log(f"[boot] trial {trial}: {dt:.2f}s  out_limbs={out.limbs} "
            f"(levels left: {(out.limbs - ctx.params.base_limbs) // ctx.params.comp}) "
            f"max_err={err:.3e} regen={ctx.rot_keys.regen_count}")

    rec = {
        "metric": f"bootstrap_slots{slots}_ring2e17",
        "value": times[-1], "unit": "s",
        "trials": times, "max_err": max(errs),
        "err_log2": float(np.log2(max(max(errs), 1e-300))),
        "gate_1e-3": bool(max(errs) <= 1e-3),
        "mult_depth": cfg.mult_depth,
        "out_levels_left": int((out.limbs - ctx.params.base_limbs)
                               // ctx.params.comp),
        "levels_consumed_from_top": int((ctx.params.nq - out.limbs)
                                        // ctx.params.comp),
        "sine_degree": bs._sine_deg, "K": bs.K,
        "raise_limbs": bs.raise_limbs,
        "rotation_keys": nkeys,
        "key_gb_each": round(key_bytes / 1e9, 3),
        "key_regens": ctx.rot_keys.regen_count,
        "security_logqp": logqp, "security_ok": ok,
        "setup_s": {"context": round(t_ctx, 1), "keys": round(t_keys, 1)},
    }
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
