"""Self-golden regression: a fixed tiny configuration stepped a fixed
number of times must keep reproducing the same numbers (float64, CPU).
Guards the numerics against unintended behavior changes in future
refactors -- the role the reference's manually-compared test programs
played (SURVEY.md section 4).

If a change legitimately alters the trajectory (e.g. a bug fix), the
expected values must be updated deliberately in the same commit.

`golden_ocean_only_box()` and `golden_coupled()` return the measured
numbers, so the same cases can be run on other devices against the
same constants (chip_smoke.py).
"""

import numpy as np
import pytest

from qgcm_tpu.config import ModelConfig, OceanConfig, double_gyre_coupled
from qgcm_tpu.model import build_model
from qgcm_tpu.models.ocean import init_ocean_state, \
    ocean_forcing_from_mean
from qgcm_tpu.models.atmos import init_atmos_state
from qgcm_tpu.models.stepper import make_ocean_only_runner, \
    make_coupled_runner
from qgcm_tpu.generators import eddy_pressure, double_gyre_windstress

RTOL = 1e-9


EXPECTED_OCEAN_ONLY_BOX = dict(
    po_sum=31.416626761421,
    po_l1=32.5480213744938,
    po_max=0.962083301276373,
    qo_l1=0.0038091058169070335,
    sst_l1=2.135746401204379,
    dpioc0=-19680485411.11134,
)

EXPECTED_COUPLED = dict(
    pa_l1=4494126.575996573,
    pa_max=10034.029753613597,
    ast_l1=3013.375749852249,
    hmixa_sum=287999.9999953847,
    po_l1=8.576337767308004,
    sst_l1=7884.8790379866205,
)


def golden_ocean_only_box():
    cfg = ModelConfig(nxta=24, nyta=24, nxaooc=16, nyaooc=8, ndxr=2,
                      fnot=9.37456e-5, beta=1.7536e-11, dta=200.0,
                      nstr=3,
                      ocean=OceanConfig(nlo=3, dxo=25.0e3, delek=2.0,
                                        hoc=(350.0, 750.0, 2900.0),
                                        gpoc=(0.015, 0.0075),
                                        tabsoc=(287.0, 282.0, 276.0),
                                        ah2oc=(0.0, 0.0, 0.0),
                                        ah4oc=(2e12, 2e12, 2e12)),
                      ocean_only=True).validate()
    model = build_model(cfg)
    st = init_ocean_state(model, po=eddy_pressure(cfg, ssh_amp=0.1))
    f = ocean_forcing_from_mean(
        model, *double_gyre_windstress(cfg, model.grids, tau0=2e-5))
    st = make_ocean_only_runner(model)(st, f, 50)

    po = np.asarray(st.po)
    qo = np.asarray(st.qo)
    sst = np.asarray(st.sst)
    return dict(
        po_sum=float(po.sum()),
        po_l1=float(np.abs(po).sum()),
        po_max=float(po.max()),
        qo_l1=float(np.abs(qo).sum()),
        sst_l1=float(np.abs(sst).sum()),
        dpioc0=float(np.asarray(st.dpioc)[0]),
    )


def golden_coupled():
    cfg = double_gyre_coupled(nxta=24, nyta=12, nxaooc=8, nyaooc=8,
                              ndxr=4, dta=180.0,
                              ocean=OceanConfig(dxo=20.0e3))
    model = build_model(cfg)
    oc = init_ocean_state(model, init="rbal")
    at = init_atmos_state(model, init="rbal")
    oc, at = make_coupled_runner(model)(oc, at, 30)
    return dict(
        pa_l1=float(np.abs(np.asarray(at.pa)).sum()),
        pa_max=float(np.asarray(at.pa).max()),
        ast_l1=float(np.abs(np.asarray(at.ast)).sum()),
        hmixa_sum=float(np.asarray(at.hmixa).sum()),
        po_l1=float(np.abs(np.asarray(oc.po)).sum()),
        sst_l1=float(np.abs(np.asarray(oc.sst)).sum()),
    )


def test_golden_ocean_only_box():
    got = golden_ocean_only_box()
    for k, v in EXPECTED_OCEAN_ONLY_BOX.items():
        assert got[k] == pytest.approx(v, rel=RTOL), (k, got)


def test_golden_coupled():
    got = golden_coupled()
    for k, v in EXPECTED_COUPLED.items():
        assert got[k] == pytest.approx(v, rel=RTOL), (k, got)
