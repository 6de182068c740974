"""Measure ms/step for every canonical configuration on the attached
GPU (bench.py reports only the double-gyre and NAtl rows).

Methodology identical to bench.py: jitted lax.scan chunks, float32,
steady state from the second re-invocation (the first re-invocation
recompiles for settled array layouts), min over reps, wall time
divided by chunk length.  Coupled rows report ms per ATMOS step (the
reference main-loop unit).

Run: python tools/bench_configs.py [--skip-natl] [--reps 3]
     (the persistent XLA cache is enabled, so re-runs are warm)
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from qgcm_tpu.backend import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402


def sync(tree):
    return jax.block_until_ready(tree)


def timed(run_once, reps):
    run_once()              # compile
    run_once()              # settle output layouts
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        run_once()
        best = min(best, time.perf_counter() - t0)
    return best


def ocean_only(cfg, steps, reps):
    from qgcm_tpu.model import build_model
    from qgcm_tpu.models.ocean import (init_ocean_state,
                                       ocean_forcing_from_mean)
    from qgcm_tpu.models.stepper import make_ocean_only_runner
    from qgcm_tpu.generators import eddy_pressure, zero_forcing

    model = build_model(cfg)
    st = init_ocean_state(model, po=eddy_pressure(cfg))
    f = ocean_forcing_from_mean(model, *zero_forcing(cfg))
    run = make_ocean_only_runner(model)
    box = [st]

    def once():
        box[0] = run(box[0], f, steps)
        sync(box[0])
    t = timed(once, reps)
    pts = cfg.nxpo * cfg.nypo * cfg.nlo
    return t / steps * 1e3, pts * steps / t


def coupled(cfg, atmos_steps, reps):
    from qgcm_tpu.model import build_model
    from qgcm_tpu.models.ocean import init_ocean_state
    from qgcm_tpu.models.atmos import init_atmos_state
    from qgcm_tpu.models.stepper import make_coupled_runner

    model = build_model(cfg)
    oc = init_ocean_state(model, init="rbal")
    at = init_atmos_state(model, init="rbal")
    run = make_coupled_runner(model)
    box = [(oc, at)]

    def once():
        box[0] = run(*box[0], atmos_steps)
        sync(box[0])
    t = timed(once, reps)
    return t / atmos_steps * 1e3, None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--skip-natl", action="store_true")
    a = ap.parse_args()
    from qgcm_tpu.config import (double_gyre_ocean_only, k247_default,
                                 southern_ocean_ocean_only, natl_1km,
                                 double_gyre_coupled,
                                 southern_ocean_coupled)
    rows = []

    def add(name, ms, rate):
        rows.append((name, ms, rate))
        print(json.dumps({"config": name, "ms_per_step": ms,
                          "updates_per_s": rate}), flush=True)

    ms, r = ocean_only(double_gyre_ocean_only(dtype="float32"),
                       250, a.reps)
    add("double_gyre_oo 961^2x3", ms, r)
    ms, r = ocean_only(k247_default(dtype="float32"), 250, a.reps)
    add("k247_default 961^2x2 cyclic", ms, r)
    ms, r = ocean_only(southern_ocean_ocean_only(dtype="float32"),
                       100, a.reps)
    add("southern_oo 4609x577x3 cyclic", ms, r)
    if not a.skip_natl:
        ms, r = ocean_only(natl_1km(dtype="float32"), 25, a.reps)
        add("natl_1km 4801^2x3", ms, r)
    ms, _ = coupled(double_gyre_coupled(dtype="float32"), 120, a.reps)
    add("double_gyre_coupled (per atmos step)", ms, None)
    ms, _ = coupled(southern_ocean_coupled(dtype="float32"), 60,
                    a.reps)
    add("southern_coupled (per atmos step)", ms, None)

    print("\nconfig".ljust(41), "ms/step   updates/s")
    for name, ms, rate in rows:
        print(f"{name:<40} {ms:8.3f}   "
              + (f"{rate:.3e}" if rate else "-"))


if __name__ == "__main__":
    main()
