#!/usr/bin/env python
"""Headline benchmark on one NVIDIA GPU: ocean grid-point-layer updates
per second.

Configs, both float32 ocean-only through make_ocean_only_runner (the
runner `qgcm run` drives), one ocean leapfrog substep = mixed layer +
QG step + PV inversion + boundary PV (reference main loop
src/q-gcm.F:1222-1255):
  - double-gyre 5 km box (961x961 p-grid, 3 layers), the reference's
    examples/double_gyre_ocean_only case -- the headline;
  - NAtl 1 km box (4801x4801x3), the largest grid, solve-bound.

Baseline: the reference publishes no throughput numbers; BASELINE.md
derives a CPU envelope of order 1e7 grid-point-layer updates/s from the
production job shape (1 process x 32 OpenMP threads, 336 h cap for a
5-year run). vs_baseline is measured against 1e7.

Exits non-zero without printing a result when JAX finds no GPU.
Prints the device on earlier lines, then ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "natl_ms_per_step": N, "natl_updates_per_s": N, "device": {...}}
"""

import json
import subprocess
import sys
import time

import jax

BASELINE_UPDATES_PER_S = 1.0e7
STEPS_PER_CHUNK = 250
NATL_STEPS = 25
REPS = 3


def measure_ocean_only(cfg, steps, reps):
    """min wall time per chunk over `reps` (after compile + layout
    settle), as (ms_per_step, updates_per_s)."""
    from qgcm_tpu.model import build_model
    from qgcm_tpu.models.ocean import (
        init_ocean_state, ocean_forcing_from_mean)
    from qgcm_tpu.models.stepper import make_ocean_only_runner
    from qgcm_tpu.generators import (eddy_pressure,
                                     double_gyre_windstress)

    model = build_model(cfg)
    st = init_ocean_state(model, po=eddy_pressure(cfg, ssh_amp=0.15))
    f = ocean_forcing_from_mean(
        model, *double_gyre_windstress(cfg, model.grids))
    run = make_ocean_only_runner(model)

    st = jax.block_until_ready(run(st, f, steps))     # compile
    st = jax.block_until_ready(run(st, f, steps))     # settle layouts
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        st = jax.block_until_ready(run(st, f, steps))
        best = min(best, time.perf_counter() - t0)
    pts = cfg.nxpo * cfg.nypo * cfg.nlo      # p-grid point-layers
    return best / steps * 1e3, pts * steps / best


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py: needs an NVIDIA GPU; JAX found "
                 f"{dev.platform!r} devices only")
    from qgcm_tpu.backend import enable_compile_cache
    from qgcm_tpu.config import double_gyre_ocean_only, natl_1km

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(f"device: {device}; nvidia-smi: {smi}; compile cache: "
          f"{enable_compile_cache()}", flush=True)

    ms, rate = measure_ocean_only(
        double_gyre_ocean_only(dtype="float32"), STEPS_PER_CHUNK, REPS)
    natl_ms, natl_rate = measure_ocean_only(
        natl_1km(ocean_only=True, dtype="float32"), NATL_STEPS, REPS)
    print(json.dumps({
        "metric": "ocean_gridpoint_layer_updates_per_s",
        "value": rate,
        "unit": "updates/s",
        "vs_baseline": rate / BASELINE_UPDATES_PER_S,
        "dg_ms_per_step": ms,
        "natl_ms_per_step": natl_ms,
        "natl_updates_per_s": natl_rate,
        "device": device,
        "nvidia_smi": smi,
    }))


if __name__ == "__main__":
    main()
