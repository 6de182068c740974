"""Ensemble x spatial-mesh composability: decide the design fork with
numbers.

models/ensemble.py shards MEMBERS over the mesh and keeps each member
on one chip (zero-collective program). The alternative -- composing a
member axis with rows-sharded members (nested shard_map / flattened
('member','y') mesh) -- is only worth building if a member either
(a) does NOT fit one chip, or (b) batches so badly on one chip that
spatial sharding per member would beat member parallelism. This tool
measures both on one card:

  1. Southern-ocean channel (4609x577x3 f32, the production channel):
     per-member step time at vmap widths m=1,2,4 + HBM in use.
  2. NAtl.1km (4801^2x3 f32, the biggest inventory config):
     single-member step time + HBM; then m=2 vmap (fit or OOM).

Run with nothing else on the card:
    python tools/bench_ensemble_mesh.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax

from qgcm_tpu.backend import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402


def sync(tree):
    return jax.block_until_ready(tree)


def hbm_gb():
    try:
        st = jax.devices()[0].memory_stats()
        return st["bytes_in_use"] / 2**30
    except Exception:
        return float("nan")


def members_case(cfg, m, steps, reps, label):
    from qgcm_tpu.model import build_model
    from qgcm_tpu.models.ocean import (init_ocean_state,
                                       ocean_forcing_from_mean)
    from qgcm_tpu.models.ensemble import (make_ensemble_runner,
                                          perturbed_ocean_members)
    from qgcm_tpu.models.stepper import make_ocean_only_runner
    from qgcm_tpu.generators import eddy_pressure, channel_windstress

    model = build_model(cfg)
    base = init_ocean_state(model, po=eddy_pressure(cfg))
    f = ocean_forcing_from_mean(
        model, *channel_windstress(cfg, model.grids))
    if m == 1:
        run = make_ocean_only_runner(model)
        st = base

        def once():
            nonlocal st
            st = run(st, f, steps)
            sync(st)
    else:
        run = make_ensemble_runner(model, kind="ocean")
        st = perturbed_ocean_members(model, base,
                                     jax.random.PRNGKey(0), m)

        def once():
            nonlocal st
            st = run(st, f, steps)
            sync(st)

    once()          # compile
    once()          # settle layouts
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        once()
        best = min(best, time.perf_counter() - t0)
    ms = best / steps * 1e3
    print(f"{label:<34} m={m}  {ms:8.2f} ms/step "
          f"({ms / m:8.2f} ms/step/member)  hbm={hbm_gb():.2f} GiB",
          flush=True)
    return ms


def main():
    from qgcm_tpu.config import southern_ocean_ocean_only, natl_1km

    print("device:", jax.devices()[0], flush=True)
    so = southern_ocean_ocean_only(dtype="float32")
    ms1 = members_case(so, 1, 100, 3, "southern_oo 4609x577x3")
    ms2 = members_case(so, 2, 100, 3, "southern_oo 4609x577x3")
    try:
        ms4 = members_case(so, 4, 50, 3, "southern_oo 4609x577x3")
    except Exception as e:
        ms4 = None
        print(f"southern m=4: {type(e).__name__}: {str(e)[:200]}",
              flush=True)
    if ms4 is not None:
        print(f"batching efficiency vs m=1: m=2 {2 * ms1 / ms2:.2f}x, "
              f"m=4 {4 * ms1 / ms4:.2f}x", flush=True)

    na = natl_1km(dtype="float32")
    na1 = members_case(na, 1, 25, 3, "natl_1km 4801^2x3")
    try:
        na2 = members_case(na, 2, 10, 2, "natl_1km 4801^2x3")
        print(f"NAtl m=2 batching efficiency vs m=1: "
              f"{2 * na1 / na2:.2f}x", flush=True)
    except Exception as e:
        print(f"NAtl m=2: {type(e).__name__}: {str(e)[:300]}",
              flush=True)


if __name__ == "__main__":
    main()
