"""Distributed-spectral-solve census on a CPU mesh of 8 virtual
devices:
  1. collective counts + bytes of the compiled Helmholtz solve: GSPMD
     auto-sharding vs the explicit all_to_all pencil path
     (parallel/spectral.py), box and cyclic;
  2. loop-body collective census of the full ocean-only runner for
     both variants (the per-step communication the mesh pays).

Run: python tools/bench_spectral.py [--grid N]
"""

import argparse
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from qgcm_tpu.config import ModelConfig, OceanConfig  # noqa: E402
from qgcm_tpu.model import build_model  # noqa: E402
from qgcm_tpu.models.ocean import (init_ocean_state,  # noqa: E402
                                   ocean_forcing_from_mean)
from qgcm_tpu.models.stepper import make_ocean_only_runner  # noqa: E402
from qgcm_tpu.generators import eddy_pressure, zero_forcing  # noqa: E402
from qgcm_tpu.parallel.mesh import make_mesh, shard_tree  # noqa: E402
from qgcm_tpu.parallel.spectral import (ShardedBoxHelmholtz,  # noqa: E402
                                        ShardedCyclicHelmholtz)
from qgcm_tpu.parallel.inspect import collective_stats  # noqa: E402
from qgcm_tpu.solver.helmholtz import (make_box_helmholtz,  # noqa: E402
                                       make_cyclic_helmholtz)


def solve_traffic(nxp, nyp):
    rng = np.random.default_rng(0)
    rdm2 = np.array([0.0, 5.9e-10, 2.3e-9])
    for name, mk, wrap, shape, rows in (
            ("box", make_box_helmholtz, ShardedBoxHelmholtz,
             (3, nyp, nxp), False),
            ("cyclic", make_cyclic_helmholtz, ShardedCyclicHelmholtz,
             (3, nyp, nxp - 2), True)):
        mesh = make_mesh(jax.devices()[:8], rows_only=rows)
        base = mk(shape[2], shape[1], 5e3, 5e3, rdm2)
        sh = wrap(base, mesh)
        rhs = jnp.asarray(rng.standard_normal(shape))
        sharding = NamedSharding(mesh, P(None, "y", "x"))

        def gspmd(r):
            r = jax.lax.with_sharding_constraint(r, sharding)
            return jax.lax.with_sharding_constraint(base.solve(r),
                                                    sharding)

        def a2a(r):
            r = jax.lax.with_sharding_constraint(r, sharding)
            return jax.lax.with_sharding_constraint(sh.solve(r),
                                                    sharding)

        for vname, fn in (("gspmd", gspmd), ("a2a", a2a)):
            s = collective_stats(fn, rhs)
            kb = sum(s.bytes_moved.values()) / 1e3
            print(f"  {name:6s} {vname:5s} KB/solve={kb:9.1f}  "
                  f"{s.counts}")


def loop_body_census(grid):
    cfg = ModelConfig(nxta=grid, nyta=grid, nxaooc=grid,
                      nyaooc=grid // 2, ndxr=2,
                      fnot=5.92e-5, beta=2.08e-11,
                      ocean=OceanConfig(nlo=2, dxo=20e3, delek=2.0,
                                        hoc=(800.0, 3200.0),
                                        gpoc=(0.01,),
                                        tabsoc=(287.0, 282.0),
                                        ah2oc=(0.0, 0.0),
                                        ah4oc=(1e10, 1e10)),
                      ocean_only=True, cyclic_ocean=False).validate()
    model = build_model(cfg)
    st = init_ocean_state(model, po=eddy_pressure(cfg))
    f = ocean_forcing_from_mean(model, *zero_forcing(cfg))
    mesh = make_mesh(jax.devices()[:8])
    st_sh, f_sh = shard_tree(st, mesh), shard_tree(f, mesh)
    for variant in (None, "a2a"):
        run = make_ocean_only_runner(model, mesh=mesh,
                                     spectral_variant=variant)
        txt = run.lower(st_sh, f_sh, 20).compile().as_text()
        body = max(re.split(r"\n(?=%|ENTRY)", txt), key=len)
        counts = {op: len(re.findall(" " + op, body))
                  for op in ("all-gather", "all-to-all",
                             "collective-permute")}
        print(f"  box runner variant={str(variant):5s} "
              f"scan-body collectives: {counts}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=48)
    ap.add_argument("--solve-size", type=int, default=961)
    args = ap.parse_args()
    print(f"== solve traffic at {args.solve_size}^2 x 3 f64, 8-device "
          "CPU mesh ==")
    solve_traffic(args.solve_size, args.solve_size)
    print("\n== full runner scan-body census ==")
    loop_body_census(args.grid)


if __name__ == "__main__":
    main()
