"""Long-horizon mesh product test through the full Driver.

Slow-drift bugs -- constraint leakage, averaging/cadence interactions,
restart-resume seams -- are invisible to the short (<=36-step)
sharding-equality tests.  Here a coarse coupled config runs 1600
coupling cycles (4800 atmos steps, 10 model days) on a rows mesh
through the production Driver with the monitoring and restart
cadences ON, resuming once mid-run from the restart dump, and the
stitched monit time series plus the final state must match the
single-device straight-through run.  Mirrors the reference main
loop's cadence interleaving (q-gcm.F:1220-1491).

Measured (8-virtual-CPU world): the mesh+resume trajectory tracks the
single-device run to ~5e-16 in po after 6000 steps -- the assertions
below leave orders of magnitude of margin and still catch any real
drift.
"""

import os

import numpy as np
import pytest
import jax
from scipy.io import netcdf_file

from qgcm_tpu.config import double_gyre_coupled, OceanConfig
from qgcm_tpu.model import build_model
from qgcm_tpu.run import Driver
from qgcm_tpu.params import RunParams
from qgcm_tpu.parallel.mesh import make_mesh
from qgcm_tpu.models.ocean import init_ocean_state
from qgcm_tpu.models.atmos import init_atmos_state
from qgcm_tpu.generators import eddy_pressure
from qgcm_tpu.io import save_restart

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs multi-device CPU mesh")

DAY = 86400.0
SEG = 2400          # atmos steps per mesh segment (2 segments)
NMON = 300          # monitoring cadence in atmos steps (100 cycles)


def _params(trun_steps, name, resday=0.0):
    return RunParams(trun=trun_steps * 180.0 / DAY / 365.0, dta=180.0,
                     nstr=3, dxo=20.0e3, valday=0.0, odiday=0.0,
                     adiday=0.0, dgnday=NMON * 180.0 / DAY, prtday=0.0,
                     resday=resday, dtavoc=0.0, dtavat=0.0, name=name)


def _monit(d, names):
    with netcdf_file(os.path.join(d, "monit.nc"), "r", mmap=False) as f:
        return {n: f.variables[n][:].copy() for n in names}


@pytest.mark.parametrize("mesh_shape", ["rows", "box2d"])
def test_longrun_mesh_with_restart_resume(tmp_path, mesh_shape):
    """mesh_shape="rows": the production rows-only (4,1) layout.
    "box2d": the 2-D (2,2) box decomposition (corner-ghost halo
    schedule, parallel/halo.py _qgstep_halo_2d)
    -- the newest decomposition gets the same slow-drift coverage
    (constraint algebra over 2-D shards, cadence/resume seams) as the
    rows path, not just kernel bit-exactness (test_halo)."""
    base = double_gyre_coupled(nxta=24, nyta=12, nxaooc=8, nyaooc=8,
                               ndxr=4, ocean=OceanConfig(dxo=20.0e3))
    model = build_model(base)
    oc = init_ocean_state(model, po=eddy_pressure(base))
    at = init_atmos_state(model, init="rbal")
    r0 = str(tmp_path / "r0.nc")
    save_restart(r0, model, oc, at, 0.0)

    # single-device straight-through control (2*SEG steps)
    ctl = Driver(model, _params(2 * SEG, r0), str(tmp_path / "ctl"),
                 verbose=False).run()
    assert not ctl.aborted and ctl.steps_done == 2 * SEG

    # mesh run in two halves: restart dump at the end of the first
    # half (resday = SEG steps, cycle-aligned), resume for the second
    mesh = make_mesh(jax.devices()[:4],
                     rows_only=(mesh_shape == "rows"))
    if mesh_shape == "box2d":
        assert dict(mesh.shape) == {"y": 2, "x": 2}
    m1 = Driver(model, _params(SEG, r0, resday=SEG * 180.0 / DAY),
                str(tmp_path / "m1"), verbose=False, mesh=mesh)
    assert m1.halo_variant == "overlap"     # production default
    r1 = m1.run()
    assert not r1.aborted
    rst = str(tmp_path / "m1" / "restart.nc")
    assert os.path.exists(rst)
    r2 = Driver(model, _params(SEG, rst), str(tmp_path / "m2"),
                verbose=False, mesh=mesh).run()
    assert not r2.aborted
    assert abs(r2.tyrs - 2 * SEG * 180.0 / (DAY * 365.0)) < 1e-12

    # stitched monit series == control series (same record times on
    # the relative ntdone grid, same values at monit's f32 precision)
    names = ("time", "kealoc", "et2moc", "emfroc", "ermaso", "cnqgoc",
             "cnqgat", "etamoc", "utauoc")
    c = _monit(str(tmp_path / "ctl"), names)
    m = {n: np.concatenate([_monit(str(tmp_path / "m1"), names)[n],
                            _monit(str(tmp_path / "m2"), names)[n]])
         for n in names}
    assert len(c["time"]) == 2 * SEG // NMON
    assert len(m["time"]) == len(c["time"])
    np.testing.assert_allclose(m["time"], c["time"], atol=1e-12)
    for n in names[1:]:
        scale = np.abs(c[n]).max() + 1e-30
        assert np.abs(c[n] - m[n]).max() <= 1e-6 * scale, n

    # constraint monitors stay at rounding level over the whole run
    assert np.abs(m["emfroc"]).max() < 1e-8
    assert np.abs(m["ermaso"]).max() < 1e-8

    # final prognostic state matches the control trajectory
    for name, a, b in (("po", r2.ocean.po, ctl.ocean.po),
                       ("sst", r2.ocean.sst, ctl.ocean.sst),
                       ("pa", r2.atmos.pa, ctl.atmos.pa),
                       ("ast", r2.atmos.ast, ctl.atmos.ast)):
        a, b = np.asarray(a), np.asarray(b)
        scale = np.abs(b).max() + 1e-30
        assert np.abs(a - b).max() <= 1e-12 * scale, name
