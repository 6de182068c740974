"""Halo-exchange census on a CPU mesh of 8 virtual devices:
  1. wall-clock of the ocean-only runner: GSPMD auto-sharding vs the
     three explicit shard_map schedules (parallel/halo.py), plus
     stencil-chain scaling at 1/2/4/8 shards (CPU times: control flow
     and relative counts only, never device numbers);
  2. collective op counts + bytes from the compiled HLO of each.

Run: python tools/bench_halo.py [--grid N] [--steps N]
"""

import argparse
import functools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from qgcm_tpu.config import ModelConfig, OceanConfig  # noqa: E402
from qgcm_tpu.model import build_model  # noqa: E402
from qgcm_tpu.models.ocean import (init_ocean_state,  # noqa: E402
                                   ocean_forcing_from_mean, _oml,
                                   _qgostep_halo)
from qgcm_tpu.models.stepper import make_ocean_only_runner  # noqa: E402
from qgcm_tpu.generators import eddy_pressure, zero_forcing  # noqa: E402
from qgcm_tpu.parallel.mesh import shard_tree  # noqa: E402
from qgcm_tpu.parallel.inspect import collective_stats  # noqa: E402

VARIANTS = (None, "staged", "deep", "overlap")


def build(nyta, cyclic=False):
    cfg = ModelConfig(nxta=nyta, nyta=nyta, nxaooc=nyta,
                      nyaooc=nyta // 2, ndxr=4,
                      fnot=9.37456e-5, beta=1.7536e-11,
                      ocean=OceanConfig(nlo=3, dxo=5e3, delek=2.0,
                                        hoc=(350.0, 750.0, 2900.0),
                                        gpoc=(0.025, 0.0125),
                                        tabsoc=(287.0, 282.0, 276.0),
                                        ah2oc=(0.0, 0.0, 0.0),
                                        ah4oc=(2e9, 2e9, 2e9)),
                      ocean_only=True, cyclic_ocean=cyclic).validate()
    model = build_model(cfg)
    st = init_ocean_state(model, po=eddy_pressure(cfg))
    f = ocean_forcing_from_mean(model, *zero_forcing(cfg))
    return model, st, f


def timeit(fn, *args, n=3):
    fn(*args)  # compile + warm
    t0 = time.perf_counter()
    for _ in range(n):
        jax.block_until_ready(fn(*args))
    return (time.perf_counter() - t0) / n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=96,
                    help="nxta=nyta (ocean grid = 4x)")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()

    model, st, f = build(args.grid)
    ny, nx = model.cfg.nypo, model.cfg.nxpo
    print(f"== ocean {nx}x{ny}x{model.cfg.nlo} f64, CPU mesh "
          f"{len(jax.devices())} devices, {args.steps} steps ==")

    devs = np.asarray(jax.devices()).reshape(len(jax.devices()), 1)
    mesh = Mesh(devs, ("y", "x"))
    st_sh, f_sh = shard_tree(st, mesh), shard_tree(f, mesh)

    print("\n-- full runner: wall / step + collective schedule --")
    for hv in VARIANTS:
        run = make_ocean_only_runner(model, mesh=mesh, halo_variant=hv)
        dt = timeit(run, st_sh, f_sh, args.steps) / args.steps
        s = collective_stats(run, st_sh, f_sh, args.steps)
        cp = s.counts.get("collective-permute", 0)
        kb = sum(s.bytes_moved.values()) / 1e3
        print(f"  {str(hv):8s} {dt*1e3:8.2f} ms/step   "
              f"collective-permutes/step={cp:3d}  total KB={kb:8.1f}  "
              f"{s.counts}")

    print("\n-- stencil chain only (qgstep_halo): shard scaling --")
    _, _, entoc, *_ = _oml(model, st, f)
    base = None
    for nshard in (1, 2, 4, 8):
        m = Mesh(devs[:nshard], ("y", "x"))
        fn = jax.jit(functools.partial(
            _qgostep_halo, model, st, f, entoc, m, "overlap"))
        dt = timeit(lambda: fn()[0])
        pts = model.cfg.nlo * ny * nx
        thr = pts / dt
        if base is None:
            base = thr
        eff = thr / (base * nshard) * 100
        print(f"  {nshard} shards: {dt*1e3:8.2f} ms  "
              f"{thr/1e6:8.1f} Mpts/s  efficiency {eff:5.1f}%")


if __name__ == "__main__":
    main()
