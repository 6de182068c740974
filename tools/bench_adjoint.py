"""Adjoint cost at production scale on one GPU.

Measures forward ms/step vs value_and_grad ms/step (remat=True, the
per-pair jax.checkpoint path) for the southern-ocean channel, f32.
The classic expectation for checkpointed reverse mode is ~3x the
primal (forward + recompute + backward); prints the measured ratio.

Run with nothing else on the card:
    python tools/bench_adjoint.py [--steps N]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax

from qgcm_tpu.backend import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp  # noqa: E402


def sync(tree):
    return jax.block_until_ready(tree)


def timed(once, reps=3):
    once()          # compile
    once()          # settle layouts
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        once()
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    a = ap.parse_args()

    from qgcm_tpu.config import southern_ocean_ocean_only
    from qgcm_tpu.model import build_model
    from qgcm_tpu.models.ocean import (init_ocean_state,
                                       ocean_forcing_from_mean)
    from qgcm_tpu.models.stepper import make_ocean_only_runner
    from qgcm_tpu.generators import eddy_pressure, channel_windstress
    from qgcm_tpu.adjoint import ocean_sensitivity, transport_proxy

    cfg = southern_ocean_ocean_only(dtype="float32")
    model = build_model(cfg)
    st0 = init_ocean_state(model, po=eddy_pressure(cfg))
    mf = channel_windstress(cfg, model.grids)
    n = a.steps
    print(f"device: {jax.devices()[0]}  grid {cfg.nypo}x{cfg.nxpo}"
          f"x{cfg.nlo} f32, {n} steps", flush=True)

    f = ocean_forcing_from_mean(model, *(jnp.asarray(x) for x in mf))
    run = make_ocean_only_runner(model)
    t_fwd = timed(lambda: sync(run(st0, f, n)))
    print(f"forward              {t_fwd / n * 1e3:8.2f} ms/step",
          flush=True)

    for remat in (True, "dots"):
        sens = ocean_sensitivity(model, transport_proxy(model),
                                 remat=remat)
        t_adj = timed(lambda: sync(sens(st0, mf, n)))
        print(f"value_and_grad remat={remat!s:<5} "
              f"{t_adj / n * 1e3:8.2f} ms/step "
              f"({t_adj / t_fwd:.2f}x forward)", flush=True)


if __name__ == "__main__":
    main()
