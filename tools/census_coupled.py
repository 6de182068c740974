"""Collective census of the COUPLED sharded cycle on a CPU mesh of 8
virtual devices: scan-body census of the coupled runner with
per-all-gather byte sizes. With the mesh-aware xforc every gather must
be bounded by the coarse atmospheric grid (ndxr^2 smaller than the
ocean/fine grids).

Run: python tools/census_coupled.py
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


from qgcm_tpu.config import double_gyre_coupled, OceanConfig  # noqa: E402
from qgcm_tpu.model import build_model  # noqa: E402
from qgcm_tpu.models.ocean import init_ocean_state  # noqa: E402
from qgcm_tpu.models.atmos import init_atmos_state  # noqa: E402
from qgcm_tpu.models.stepper import make_coupled_runner  # noqa: E402
from qgcm_tpu.parallel.mesh import make_mesh, shard_tree  # noqa: E402
from qgcm_tpu.parallel.inspect import _shape_bytes  # noqa: E402


def _body(txt):
    return max(re.split(r"\n(?=%|ENTRY)", txt), key=len)


def _census(body, esz, cfg):
    counts = {op: len(re.findall(" " + op, body))
              for op in ("all-gather", "all-to-all",
                         "collective-permute")}
    gsizes = sorted(_shape_bytes(l) for l in body.splitlines()
                    if re.search(r"=\s+\S*\s*all-gather(-start)?\(",
                                 l.strip()))
    atmos_b = esz * (-(-cfg.nypa // 8) * 8) * cfg.nxpa
    ocean_b = esz * cfg.nypo * cfg.nxpo
    print(f"  collectives: {counts}")
    print(f"  all-gather bytes: {gsizes}")
    print(f"  bound: atmos p-grid = {atmos_b} B; ocean p-grid = "
          f"{ocean_b} B ({ocean_b // max(atmos_b, 1)}x)")
    ok = not gsizes or max(gsizes) <= atmos_b
    print(f"  -> max gather {'<=' if ok else 'EXCEEDS'} atmos bound")
    return ok


def cpu_census():
    cfg = double_gyre_coupled(nxta=16, nyta=16, nxaooc=12, nyaooc=12,
                              ndxr=4, dta=180.0,
                              ocean=OceanConfig(dxo=20.0e3)).validate()
    model = build_model(cfg)
    mesh = make_mesh(jax.devices()[:8], rows_only=True)
    ocean = shard_tree(init_ocean_state(model, init="rbal"), mesh)
    atmos = shard_tree(init_atmos_state(model, init="rbal"), mesh)
    run = make_coupled_runner(model, mesh=mesh, spectral_variant="a2a")
    txt = run.lower(ocean, atmos, 2 * cfg.nstr).compile().as_text()
    print("== coupled scan-body census, 8-device CPU mesh (f64, "
          f"ocean {cfg.nxpo}x{cfg.nypo}, ndxr={cfg.ndxr}) ==")
    _census(_body(txt), 8, cfg)


def main():
    argparse.ArgumentParser(description=__doc__).parse_args()
    cpu_census()


if __name__ == "__main__":
    main()
