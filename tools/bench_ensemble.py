#!/usr/bin/env python
"""Measure ensemble (vmap member-axis) batching efficiency on one chip.

Compares m-member vmapped stepping against m sequential
single-trajectory runs at several double-gyre box sizes:
speedup = m * T_single / T_ensemble. Small grids underfill the chip,
so batching should approach the m-fold ideal there and fall toward
1x as a single member saturates the chip.

Run on the GPU (same methodology as bench.py: f32, scan chunks,
steady state after a warmup re-invocation, min of reps).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax

from qgcm_tpu.backend import enable_compile_cache  # noqa: E402

enable_compile_cache()


REPS = 3
MEMBERS = 8


def sync(tree):
    return jax.block_until_ready(tree)


def bench(fn, *args):
    sync(fn(*args))          # compile
    sync(fn(*args))          # steady state (first re-call recompiles)
    best = float("inf")
    for _ in range(REPS):
        t0 = time.perf_counter()
        sync(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    from qgcm_tpu.config import double_gyre_ocean_only
    from qgcm_tpu.model import build_model
    from qgcm_tpu.models.ocean import (init_ocean_state,
                                       ocean_forcing_from_mean)
    from qgcm_tpu.models.stepper import make_ocean_only_runner
    from qgcm_tpu.models.ensemble import (perturbed_ocean_members,
                                          make_ensemble_runner)
    from qgcm_tpu.generators import eddy_pressure, double_gyre_windstress

    from qgcm_tpu.backend import default_dtype
    dtype = default_dtype()
    print(f"backend {jax.default_backend()}  dtype {dtype}  "
          f"members {MEMBERS}")
    print(f"{'ocean':>10} {'steps':>6} {'T1 ms/st':>9} "
          f"{'Tens ms/st':>10} {'speedup':>8} {'eff %':>6}")
    for naooc, steps in ((8, 400), (15, 400), (30, 200), (60, 100)):
        cfg = double_gyre_ocean_only(nxaooc=naooc, nyaooc=naooc,
                                     dtype=dtype)
        model = build_model(cfg)
        po = eddy_pressure(cfg, ssh_amp=0.15)
        st = init_ocean_state(model, po=po)
        forcing = ocean_forcing_from_mean(
            model, *double_gyre_windstress(cfg, model.grids))
        members = perturbed_ocean_members(
            model, st, jax.random.PRNGKey(0), MEMBERS, amp=1e-3)

        run1 = make_ocean_only_runner(model)
        t1 = bench(lambda s: run1(s, forcing, steps), st) / steps
        rune = make_ensemble_runner(model, kind="ocean")
        te = bench(lambda ms: rune(ms, forcing, steps),
                   members) / steps
        sp = MEMBERS * t1 / te
        print(f"{cfg.nxpo}^2x{cfg.nlo:<3} {steps:>6} {t1*1e3:>9.3f} "
              f"{te*1e3:>10.3f} {sp:>8.2f} {100*sp/MEMBERS:>6.1f}")


if __name__ == "__main__":
    main()
