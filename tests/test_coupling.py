"""xforc coupling tests: bicubic refinement properties, windstress,
Ekman fields, and heat-flux bookkeeping."""

import numpy as np
import jax.numpy as jnp
import pytest

from qgcm_tpu.config import double_gyre_coupled, OceanConfig, AtmosConfig
from qgcm_tpu.model import build_model
from qgcm_tpu.models.ocean import init_ocean_state
from qgcm_tpu.models.atmos import init_atmos_state
from qgcm_tpu.coupling import make_xforc, bicubic_refine_uv


def _model(**over):
    cfg = double_gyre_coupled(nxta=24, nyta=12, nxaooc=8, nyaooc=8,
                              ndxr=4, dta=180.0,
                              ocean=OceanConfig(dxo=20.0e3), **over)
    return build_model(cfg)


@pytest.fixture(scope="module")
def model():
    return _model()


def test_bicubic_interpolates_nodes(model):
    """The bicubic interpolant passes through the coarse data at every
    shared gridpoint, including the boundary bands."""
    cfg = model.cfg
    rng = np.random.default_rng(0)
    u = rng.standard_normal((cfg.nypa, cfg.nxta))
    v = rng.standard_normal((cfg.nypa, cfg.nxta))
    u = np.concatenate([u, u[:, :1]], axis=1)   # cyclic duplicate
    v = np.concatenate([v, v[:, :1]], axis=1)
    uf, vf = bicubic_refine_uv(model.coupling, jnp.asarray(u),
                               jnp.asarray(v), cfg.ndxr)
    assert uf.shape == (cfg.nypaor, cfg.nxpaor)
    nd = cfg.ndxr
    assert np.allclose(np.asarray(uf)[::nd, ::nd], u, atol=1e-12)
    assert np.allclose(np.asarray(vf)[::nd, ::nd], v, atol=1e-12)
    # cyclicity
    assert np.allclose(np.asarray(uf)[:, 0], np.asarray(uf)[:, -1])


def test_bicubic_reproduces_bilinear_interior(model):
    """Away from the wall bands, the scheme reproduces bilinear
    functions exactly (centred-difference bicubic is exact for
    polynomials of degree <= 1 per direction)."""
    cfg = model.cfg
    nd = cfg.ndxr
    jj = np.arange(cfg.nypa)[:, None]
    ii = np.arange(cfg.nxta)[None, :]
    # x must be cyclic: use constant in x, linear in y
    u = 2.0 + 0.25 * jj + 0.0 * ii
    u = np.concatenate([u, u[:, :1]], axis=1)
    v = np.zeros_like(u)
    uf, _ = bicubic_refine_uv(model.coupling, jnp.asarray(u),
                              jnp.asarray(v), nd)
    jf = np.arange(cfg.nypaor)[:, None] / nd
    expect = 2.0 + 0.25 * jf + np.zeros((1, cfg.nxpaor))
    interior = slice(nd, -(nd + 1))
    assert np.allclose(np.asarray(uf)[interior], expect[interior],
                       atol=1e-12)


def test_xforc_constant_wind(model):
    """A y-linear pam (constant geostrophic wind, with bccoat=0 so the
    wall rows agree) gives spatially constant stress, zero Ekman
    velocities everywhere, and consistent ocean/atmos stress scaling."""
    m = _model(atmos=AtmosConfig(bccoat=0.0))
    cfg = m.cfg
    c = 1.0e-3
    y = np.arange(cfg.nypa)[:, None] * m.grids.dya
    pam = np.broadcast_to(
        (c * y)[None], (cfg.nla, cfg.nypa, cfg.nxpa)).copy()
    oc = init_ocean_state(m, init="rbal")
    at = init_atmos_state(m, init="rbal", pa=pam)
    ofor, afor, diags = make_xforc(m)(
        at.pam, oc.pom, oc.sstm, at.astm, at.hmixam)

    taux = np.asarray(afor.tauxa)
    assert np.allclose(taux, taux[0, 0], rtol=1e-10)
    assert np.allclose(np.asarray(afor.tauya),
                       np.asarray(afor.tauya)[0, 0], rtol=1e-8,
                       atol=1e-12 * abs(taux[0, 0]))
    raoro = cfg.rhoat / cfg.rhooc
    assert np.allclose(np.asarray(ofor.tauxo), raoro * taux[0, 0],
                       rtol=1e-10)
    for name, f in [("wekta", afor.wekta), ("wekpa", afor.wekpa),
                    ("wekto", ofor.wekto), ("wekpo", ofor.wekpo)]:
        scale = abs(taux[0, 0]) / (m.grids.dxo * abs(cfg.fnot))
        assert np.abs(np.asarray(f)).max() < 1e-8 * scale, name

    # quadratic drag magnitude sanity: |tau| ~ cd*|u|^2 regime check
    hmat = cfg.mixed.hmat
    cdh = (cfg.cdat / cfg.fnot) / hmat
    u0 = -c / cfg.fnot
    qu2 = 4.0 * cdh * cdh
    scasqd = -0.5 + 0.5 * np.sqrt(1.0 + qu2 * u0 * u0)
    scashr = np.sqrt(scasqd)
    cdochi = (cfg.cdat / abs(cdh)) * scashr / (1.0 + scasqd)
    assert np.allclose(taux[0, 0], cdochi * u0, rtol=1e-12)


def test_xforc_heat_flux_bookkeeping(model):
    """fnetoc/fnetat: land cells carry the radiative perturbation only;
    ocean-covered atmos cells aggregate the ocean fluxes with the
    area-ratio factor (xfosubs.F:736-800)."""
    cfg = model.cfg
    oc = init_ocean_state(model, init="rbal")
    at = init_atmos_state(model, init="rbal")
    ofor, afor, diags = make_xforc(model)(
        at.pam, oc.pom, oc.sstm, at.astm, at.hmixam)
    assert np.isfinite(np.asarray(ofor.fnetoc)).all()
    assert np.isfinite(np.asarray(afor.fnetat)).all()
    # At rbal init, sst == sstbar and ast == astbar: sensible/latent
    # + radiative fluxes are meridional profiles; x-variation only via
    # the bilinear interpolation at the ocean box edges: fnetoc must be
    # x-uniform in the box interior.
    fo = np.asarray(ofor.fnetoc)
    assert np.allclose(fo[:, 1:-1], fo[:, 1:2], rtol=1e-8)


def test_xforc_stress_integrals_consistent(model):
    """Stokes-theorem cross-check the reference prints for debugging
    (xfosubs.F:469-489): Integ(wekpa) dA == (txisat - txinat)/fnot over
    the interior p cells."""
    cfg = model.cfg
    g = model.grids
    oc = init_ocean_state(model, init="rbal")
    rng = np.random.default_rng(1)
    pam = 500.0 * rng.standard_normal((cfg.nla, cfg.nypa, cfg.nxta))
    pam = np.concatenate([pam, pam[:, :, :1]], axis=2)
    at = init_atmos_state(model, init="rbal", pa=pam)
    ofor, afor, _ = make_xforc(model)(
        at.pam, oc.pom, oc.sstm, at.astm, at.hmixam)
    wekpa = np.asarray(afor.wekpa)
    inner = wekpa[1:-1, 1:-1].sum() + 0.5 * (
        wekpa[1:-1, 0].sum() + wekpa[1:-1, -1].sum())
    lhs = g.dxa * g.dya * inner
    rhs = (float(afor.txisat) - float(afor.txinat)) / cfg.fnot
    assert np.isclose(lhs, rhs, rtol=2e-2)


def test_float32_dtype_purity():
    """A float32 coupled step must not promote any field to float64
    (x64 is globally enabled for CPU parity, so any strong-typed NumPy
    scalar in the forcing/step pipeline would silently poison the
    float32 production path)."""
    m = _model(dtype="float32")
    from qgcm_tpu.models.atmos import make_atmos_step
    from qgcm_tpu.models.ocean import make_ocean_step
    oc = init_ocean_state(m, init="rbal")
    at = init_atmos_state(m, init="rbal")
    ofor, afor, _ = make_xforc(m)(at.pam, oc.pom, oc.sstm,
                                  at.astm, at.hmixam)
    for tree, label in ((ofor, "ofor"), (afor, "afor")):
        for name, v in zip(tree._fields, tree):
            assert v.dtype == np.float32, f"{label}.{name} {v.dtype}"
    oc2, _ = make_ocean_step(m)(oc, ofor)
    at2, _ = make_atmos_step(m)(at, afor)
    for tree, label in ((oc2, "ocean"), (at2, "atmos")):
        for name, v in zip(tree._fields, tree):
            assert v.dtype == np.float32, f"{label}.{name} {v.dtype}"
