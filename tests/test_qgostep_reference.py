"""The QG vorticity step (models/ocean._qgostep) against an independent
NumPy reference written point by point from the reference's loops
(src/qgosubs.F:45-229, ocadif :231-454), its batching under vmap, and
the precision of every contraction in the float32 steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qgcm_tpu.config import ModelConfig, OceanConfig, SpongeConfig
from qgcm_tpu.model import build_model
from qgcm_tpu.models.ocean import (init_ocean_state,
                                   ocean_forcing_from_mean, _oml,
                                   _qgostep)
from qgcm_tpu.generators import eddy_pressure, double_gyre_windstress


def _setup(cyclic, sponge, dtype="float64"):
    cfg = ModelConfig(
        nxta=20 if cyclic else 24, nyta=24, nxaooc=20, nyaooc=10, ndxr=2,
        fnot=5.92e-5, beta=2.08e-11, dtype=dtype,
        ocean=OceanConfig(nlo=3, dxo=20e3, delek=2.0,
                          hoc=(350.0, 750.0, 2900.0),
                          gpoc=(0.015, 0.0075),
                          tabsoc=(287.0, 282.0, 276.0),
                          ah2oc=(10.0, 20.0, 30.0),
                          ah4oc=(1e10, 2e10, 3e10)),
        ocean_only=True, cyclic_ocean=cyclic,
        sponge=SpongeConfig(enabled=sponge)).validate()
    model = build_model(cfg)
    po = eddy_pressure(cfg)
    rng = np.random.default_rng(7)
    st = init_ocean_state(model, po=po + 0.01 * rng.standard_normal(
        po.shape), pom=po)
    f = ocean_forcing_from_mean(
        model, *double_gyre_windstress(cfg, model.grids))
    entoc = _oml(model, st, f)[2]
    return model, st, f, entoc


def _np_qgostep(model, st, f, entoc):
    """Point-by-point NumPy PV leapfrog (float64)."""
    cfg, g = model.cfg, model.grids
    cyclic = cfg.cyclic_ocean
    pom, po, qo, qom = (np.asarray(x, np.float64)
                        for x in (st.pom, st.po, st.qo, st.qom))
    wek, ent = np.asarray(f.wekpo), np.asarray(entoc)
    nl, ny, nx = po.shape
    dxm2 = 1.0 / g.dxo ** 2
    bcfac = cfg.ocean.bccooc * dxm2 / (0.5 * cfg.ocean.bccooc + 1.0)
    adfac = 1.0 / (12.0 * g.dxo * g.dyo * cfg.fnot)
    tdt = 2.0 * cfg.dto

    def east(i):
        return (i + 1 if i < nx - 1 else 1) if cyclic else i + 1

    def west(i):
        return (i - 1 if i > 0 else nx - 2) if cyclic else i - 1

    def del2(p):
        out = np.zeros_like(p)
        for j in range(ny):
            for i in range(nx):
                c = p[:, j, i]
                if j == 0:
                    out[:, j, i] = bcfac * (p[:, 1, i] - c)
                elif j == ny - 1:
                    out[:, j, i] = bcfac * (p[:, ny - 2, i] - c)
                elif not cyclic and i == 0:
                    out[:, j, i] = bcfac * (p[:, j, 1] - c)
                elif not cyclic and i == nx - 1:
                    out[:, j, i] = bcfac * (p[:, j, nx - 2] - c)
                else:
                    out[:, j, i] = dxm2 * (p[:, j + 1, i] + p[:, j - 1, i]
                                           + p[:, j, east(i)]
                                           + p[:, j, west(i)] - 4.0 * c)
        return out

    def edge(j, i):
        return j in (0, ny - 1) or (not cyclic and i in (0, nx - 1))

    d2 = del2(pom)
    d4 = del2(d2)
    qnew = qo.copy()
    for j in range(1, ny - 1):
        for i in range(nx):
            if edge(j, i):
                continue
            e, w = east(i), west(i)
            d6 = dxm2 * (d4[:, j + 1, i] + d4[:, j - 1, i] + d4[:, j, e]
                         + d4[:, j, w] - 4.0 * d4[:, j, i])

            def q_(jj, ii):
                return qo[:, jj, ii]

            def p_(jj, ii):
                return po[:, jj, ii]

            jac = ((q_(j, e) - q_(j, w)) * (p_(j + 1, i) - p_(j - 1, i))
                   + (q_(j - 1, i) - q_(j + 1, i)) * (p_(j, e) - p_(j, w))
                   + q_(j, e) * (p_(j + 1, e) - p_(j - 1, e))
                   - q_(j, w) * (p_(j + 1, w) - p_(j - 1, w))
                   - q_(j + 1, i) * (p_(j + 1, e) - p_(j + 1, w))
                   + q_(j - 1, i) * (p_(j - 1, e) - p_(j - 1, w))
                   + p_(j + 1, i) * (q_(j + 1, e) - q_(j + 1, w))
                   - p_(j - 1, i) * (q_(j - 1, e) - q_(j - 1, w))
                   - p_(j, e) * (q_(j + 1, e) - q_(j - 1, e))
                   + p_(j, w) * (q_(j + 1, w) - q_(j - 1, w)))
            dqdt = (adfac * jac
                    + np.asarray(cfg.ocean.ah2oc) / cfg.fnot * d4[:, j, i]
                    - np.asarray(cfg.ocean.ah4oc) / cfg.fnot * d6)
            dqdt[0] += cfg.fnot / cfg.ocean.hoc[0] * (wek[j, i]
                                                      - ent[j, i])
            dqdt[1] += cfg.fnot / cfg.ocean.hoc[1] * ent[j, i]
            dqdt[-1] -= (0.5 * np.sign(cfg.fnot) * cfg.ocean.delek
                         / cfg.ocean.hoc[-1] * d2[-1, j, i])
            qn = qom[:, j, i] + tdt * dqdt
            if cfg.sponge.enabled:
                betay = cfg.beta * g.yporel[j]
                qn = qn + tdt * cfg.sponge.c1_spl * np.asarray(
                    model.r_spl)[j, i] * (qom[:, j, i] - betay)
            qnew[:, j, i] = qn
    if not cyclic:
        # box W/E columns: no advective/diffusive tendency, forcing only
        for i in (0, nx - 1):
            for j in range(1, ny - 1):
                dq = np.zeros(nl)
                dq[0] = cfg.fnot / cfg.ocean.hoc[0] * (wek[j, i] - ent[j, i])
                dq[1] = cfg.fnot / cfg.ocean.hoc[1] * ent[j, i]
                dq[-1] -= (0.5 * np.sign(cfg.fnot) * cfg.ocean.delek
                           / cfg.ocean.hoc[-1] * d2[-1, j, i])
                qnew[:, j, i] = qom[:, j, i] + tdt * dq
    return qnew


@pytest.mark.parametrize("cyclic,sponge", [(False, False), (True, False),
                                           (True, True)],
                         ids=["box", "cyclic", "cyclic_sponge"])
def test_qgostep_matches_numpy_reference(cyclic, sponge):
    model, st, f, entoc = _setup(cyclic, sponge)
    q, qm, _ = _qgostep(model, st, f, entoc)
    ref = _np_qgostep(model, st, f, entoc)
    q = np.asarray(q)
    incr = np.abs(ref - np.asarray(st.qom)).max()
    assert incr > 0
    np.testing.assert_allclose(q, ref, rtol=0, atol=1e-12 * incr)
    np.testing.assert_array_equal(np.asarray(qm), np.asarray(st.qo))


@pytest.mark.parametrize("cyclic", [False, True], ids=["box", "cyclic"])
def test_qgostep_vmap_matches_member_loop(cyclic):
    """Members batched under jax.vmap (the ensemble runner's layout)
    reproduce the per-member step bit for bit."""
    model, st, f, entoc = _setup(cyclic, False, dtype="float32")
    scale = jnp.asarray([1.0, 0.5, -0.25], st.po.dtype)
    members = jax.tree.map(
        lambda x: jnp.stack([x * s for s in scale])
        if x.ndim == 3 else jnp.stack([x] * len(scale)), st)

    def one(s):
        return _qgostep(model, s, f, entoc)[0]

    batched = np.asarray(jax.jit(jax.vmap(one))(members))
    for i in range(len(scale)):
        m = jax.tree.map(lambda x: x[i], members)
        np.testing.assert_array_equal(batched[i],
                                      np.asarray(jax.jit(one)(m)))


def _dot_precisions(jaxpr):
    """Precision params of every dot_general in a jaxpr, sub-jaxprs
    (scan/cond/pjit bodies) included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    out.extend(_dot_precisions(inner))
    return out


@pytest.mark.parametrize("which", ["ocean", "atmos", "coupled"])
def test_float32_steps_state_every_contraction_precision(which):
    """On a GPU an f32 contraction with no precision may run in TF32
    (~3 digits). Every dot_general in the float32 ocean, atmosphere and
    coupled steps must carry an explicit precision."""
    from qgcm_tpu.config import double_gyre_coupled
    from qgcm_tpu.models.atmos import init_atmos_state, make_atmos_step
    from qgcm_tpu.models.ocean import make_ocean_step
    from qgcm_tpu.models.stepper import make_coupled_runner
    from qgcm_tpu.coupling import make_xforc

    cfg = double_gyre_coupled(nxta=24, nyta=12, nxaooc=8, nyaooc=8,
                              ndxr=4, dtype="float32")
    model = build_model(cfg)
    oc = init_ocean_state(model, init="rbal")
    at = init_atmos_state(model, init="rbal")
    ofor, afor, _ = make_xforc(model)(at.pam, oc.pom, oc.sstm, at.astm,
                                      at.hmixam)
    if which == "ocean":
        jx = jax.make_jaxpr(make_ocean_step(model))(oc, ofor)
    elif which == "atmos":
        jx = jax.make_jaxpr(make_atmos_step(model))(at, afor)
    else:
        run = make_coupled_runner(model, jit=False)
        jx = jax.make_jaxpr(lambda o, a: run(o, a, cfg.nstr))(oc, at)
    precs = _dot_precisions(jx.jaxpr)
    assert precs, "no contraction found"
    assert all(p is not None for p in precs), precs
