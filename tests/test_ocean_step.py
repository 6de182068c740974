"""End-to-end ocean substep tests on small grids: inversion/PV
round-trip consistency, mass-constraint enforcement, stability and
approximate energy behaviour of an unforced eddy."""

import jax.numpy as jnp
import numpy as np
import pytest

from qgcm_tpu import config as qc
from qgcm_tpu.model import build_model
from qgcm_tpu.models.ocean import (
    make_ocean_step, init_ocean_state, ocean_forcing_from_mean)
from qgcm_tpu.models.stepper import make_ocean_only_runner
from qgcm_tpu.generators import eddy_pressure, zero_forcing
from qgcm_tpu.ops.vorticity import qcomp
from qgcm_tpu.ops.integrals import xintp


def small_box_cfg(**kw):
    return qc.ModelConfig(
        nxta=16, nyta=16, nxaooc=8, nyaooc=8, ndxr=3,
        ocean_only=True, cyclic_ocean=False, dta=200.0, nstr=3,
    ).replace(**kw).validate()


def small_cyclic_cfg(**kw):
    return qc.ModelConfig(
        nxta=16, nyta=16, nxaooc=16, nyaooc=8, ndxr=3,
        ocean_only=True, cyclic_ocean=True, dta=200.0, nstr=3,
    ).replace(**kw).validate()


def _setup(cfg, forcing_arrays=None):
    model = build_model(cfg)
    po = eddy_pressure(cfg, ssh_amp=0.05, l_efold=3 * cfg.ocean.dxo)
    state = init_ocean_state(model, po=po)
    if forcing_arrays is None:
        forcing_arrays = zero_forcing(cfg)
    forcing = ocean_forcing_from_mean(model, *forcing_arrays)
    return model, state, forcing


@pytest.mark.parametrize("case", ["box", "cyclic"])
def test_inversion_pv_roundtrip(case):
    """After a step, qcomp(po_new) must equal the stepped qo at all
    interior points: the inversion is the exact inverse of the PV
    operator (incl. homogeneous corrections)."""
    cfg = small_box_cfg() if case == "box" else small_cyclic_cfg()
    model, state, forcing = _setup(cfg)
    step = make_ocean_step(model)
    for _ in range(3):
        state, diags = step(state, forcing)
    q_re = qcomp(state.po, jnp.asarray(model.modes_oc.amat),
                 jnp.asarray(model.grids.yporel),
                 1.0 / model.grids.dxo**2, cfg.fnot, cfg.beta,
                 jnp.asarray(model.topo.ddynoc), cfg.nlo - 1,
                 cfg.cyclic_ocean)
    q_re = np.asarray(q_re)
    qo = np.asarray(state.qo)
    if case == "box":
        sl = np.s_[:, 1:-1, 1:-1]
    else:
        sl = np.s_[:, 1:-1, :]
    scale = np.abs(qo[sl] - cfg.beta
                   * np.asarray(model.grids.yporel)[None, 1:-1, None]).max()
    assert np.abs(q_re[sl] - qo[sl]).max() < 1e-10 * max(scale, 1e-30)


@pytest.mark.parametrize("case", ["box", "cyclic"])
def test_mass_constraint(case):
    """Area integral of each interface displacement must track the
    constraint state dpioc exactly (thickness conservation)."""
    cfg = small_box_cfg() if case == "box" else small_cyclic_cfg()
    model, state, forcing = _setup(cfg)
    step = make_ocean_step(model)
    for _ in range(5):
        state, diags = step(state, forcing)
    area = model.grids.dxo * model.grids.dyo
    eta_int = np.asarray(
        xintp(state.po[1:] - state.po[:-1], model.wop) * area)
    np.testing.assert_allclose(eta_int, np.asarray(state.dpioc),
                               rtol=1e-8, atol=1e-6)
    # the model's own continuity error monitor should be small
    if case == "cyclic":
        assert np.abs(np.asarray(diags.emfroc)).max() < 1e-6


def test_unforced_eddy_stability_and_energy():
    """Inviscid unforced eddy: run 200 steps; fields stay finite and
    total energy is conserved to ~1e-6 relative (leapfrog is neutrally
    stable; the 25-step averaging dissipates only the computational
    mode, measured ~2e-9/step). This is the tight oracle -- a sign or
    factor error in the Jacobian, inversion or constraints moves it by
    orders of magnitude."""
    cfg = small_box_cfg(
        ocean=qc.OceanConfig(ah2oc=(0.0,) * 3, ah4oc=(0.0,) * 3,
                             delek=0.0),
        no_oml=True,
    )
    model, state, forcing = _setup(cfg)
    runner = make_ocean_only_runner(model, jit=True)

    def energy(st):
        # KE ~ sum |grad p|^2 * h / f^2 ; PE ~ sum eta^2 * gp
        po = np.asarray(st.po)
        ke = 0.0
        for k in range(cfg.nlo):
            px = np.diff(po[k], axis=1) / model.grids.dxo
            py = np.diff(po[k], axis=0) / model.grids.dyo
            ke += cfg.ocean.hoc[k] * ((px**2).sum() + (py**2).sum())
        pe = 0.0
        for k in range(cfg.nlo - 1):
            eta = (po[k + 1] - po[k]) / cfg.ocean.gpoc[k]
            pe += cfg.ocean.gpoc[k] * (eta**2).sum()
        return 0.5 * (ke / cfg.fnot**2 + pe)

    e0 = energy(state)
    state = runner(state, forcing, 200)
    assert np.isfinite(np.asarray(state.po)).all()
    assert np.isfinite(np.asarray(state.qo)).all()
    e1 = energy(state)
    assert abs(e1 - e0) < 1e-6 * e0


def test_forced_run_spins_up():
    """With windstress, energy should grow from rest."""
    from qgcm_tpu.generators import double_gyre_windstress
    cfg = small_box_cfg()
    model = build_model(cfg)
    f = double_gyre_windstress(cfg, model.grids, tau0=2e-5)
    state = init_ocean_state(model, init="rbal")
    forcing = ocean_forcing_from_mean(model, *f)
    runner = make_ocean_only_runner(model, jit=True)
    state = runner(state, forcing, 100)
    po = np.asarray(state.po)
    assert np.isfinite(po).all()
    assert np.abs(po).max() > 0.0


def test_anticyclone_beta_drifts_southwest():
    """Physics oracle: an unforced NH anticyclonic eddy on a beta
    plane self-advects SOUTHWEST (beta drift: westward at long-Rossby
    speed, southward from the beta-gyre circulation). A sign error in
    beta, the Jacobian, or the inversion flips the direction."""
    cfg = qc.ModelConfig(
        nxta=24, nyta=24, nxaooc=24, nyaooc=12, ndxr=4,
        fnot=5.92e-5, beta=2.08e-11, dta=150.0, nstr=3,
        ocean=qc.OceanConfig(nlo=2, dxo=10e3, delek=0.0,
                             hoc=(800.0, 3200.0), gpoc=(0.01,),
                             tabsoc=(287.0, 282.0),
                             ah2oc=(0.0, 0.0), ah4oc=(0.0, 0.0)),
        ocean_only=True, cyclic_ocean=True).validate()
    model = build_model(cfg)
    st0 = init_ocean_state(model, po=eddy_pressure(cfg))
    f = ocean_forcing_from_mean(model, *zero_forcing(cfg))
    st = make_ocean_only_runner(model, jit=True)(st0, f, 3000)

    def centroid(p):
        """Centre of mass of the eddy core (p > half max)."""
        w = np.where(p > 0.5 * p.max(), p, 0.0)
        jj, ii = np.mgrid[: p.shape[0], : p.shape[1]]
        return (w * jj).sum() / w.sum(), (w * ii).sum() / w.sum()

    j0, i0 = centroid(np.asarray(st0.po[0], np.float64))
    j1, i1 = centroid(np.asarray(st.po[0], np.float64))
    # ~5 model days: the drift must be clearly resolved (>0.3 cells)
    assert j1 < j0 - 0.3, (j0, j1)
    assert i1 < i0 - 0.3, (i0, i1)
    # the eddy survives (amplitude decays only slowly)
    assert np.asarray(st.po[0]).max() > 0.6 * np.asarray(st0.po[0]).max()


@pytest.mark.parametrize("case", ["box", "cyclic"])
def test_matmul_solver_trajectory_matches_fft(case, monkeypatch):
    """Model-level wiring check for the matmul DST (with_dst): a short
    run must reproduce the FFT-solver trajectory to roundoff, in both
    domains, with the radix split forced active (solver-level
    equality alone would miss a permuted-vector / constraint-algebra
    mismatch in _ocinvq)."""
    import qgcm_tpu.solver.helmholtz as H
    from qgcm_tpu.model import with_dst
    monkeypatch.setattr(H, "_MM_SPLIT_MIN", 4)
    mk = small_box_cfg if case == "box" else small_cyclic_cfg
    states = {}
    for tr in ("fft", "matmul"):
        model, state, forcing = _setup(mk())
        run = make_ocean_only_runner(with_dst(model, tr))
        states[tr] = run(state, forcing, 24)
    a, b = states["fft"], states["matmul"]
    for name in ("po", "qo", "sst"):
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        scale = np.abs(x).max()
        assert np.abs(x - y).max() <= 1e-10 * scale, (case, name)


def test_barotropic_rossby_wave_dispersion():
    """Quantitative dynamics oracle: a single barotropic harmonic in
    the unforced inviscid channel is an EXACT nonlinear solution
    (Arakawa J(p, c*p) vanishes identically), so its phase must rotate
    at the Rossby frequency omega = -beta k/(k^2+l^2) -- westward.
    Catches sign/factor errors in the beta term, the Jacobian and the
    inversion that magnitude-only tests miss. Tolerance covers the
    5-point discrete dispersion at ~21 points/wavelength."""
    from qgcm_tpu.models.stepper import make_ocean_only_runner

    cfg = qc.ModelConfig(
        nxta=64, nyta=16, nxaooc=64, nyaooc=16, ndxr=1,
        fnot=9.4e-5, beta=1.75e-11, dta=200.0, nstr=3,
        ocean=qc.OceanConfig(nlo=3, dxo=10e3, delek=0.0,
                             hoc=(350., 750., 2900.),
                             gpoc=(0.025, 0.0125),
                             tabsoc=(287., 282., 276.),
                             ah2oc=(0., 0., 0.), ah4oc=(0., 0., 0.)),
        ocean_only=True, cyclic_ocean=True).validate()
    model = build_model(cfg)
    g = model.grids
    nxp, nyp = cfg.nxpo, cfg.nypo
    nx, ny = nxp - 1, nyp - 1
    dx = g.dxo
    kx = 2 * np.pi * 3 / (nx * dx)        # 3 wavelengths around
    ly = np.pi / (ny * dx)                # first meridional mode
    x = np.arange(nxp) * dx
    y = np.arange(nyp) * dx
    amp = 1e-4 * cfg.fnot * dx * dx       # linear regime
    wave = amp * np.sin(ly * y)[:, None] * np.cos(kx * x)[None, :]
    state = init_ocean_state(model, po=np.repeat(wave[None], 3, 0))
    forcing = ocean_forcing_from_mean(model, *zero_forcing(cfg))
    run = make_ocean_only_runner(model)

    def phase(st):
        p = np.asarray(st.po[0])[:, :nx]
        cy = np.sin(ly * y)[:, None]
        c = (p * cy * np.cos(kx * x[:nx])[None, :]).sum()
        s = (p * cy * np.sin(kx * x[:nx])[None, :]).sum()
        return np.arctan2(s, c)

    ths = [phase(state)]
    for _ in range(6):
        state = run(state, forcing, 50)
        ths.append(phase(state))
    omega = np.unwrap(np.diff(ths)).mean() / (50 * cfg.dto)
    omega_ref = -cfg.beta * kx / (kx**2 + ly**2)
    assert omega < 0, "Rossby wave must propagate westward"
    assert abs(omega - omega_ref) < 0.05 * abs(omega_ref), \
        (omega, omega_ref)


def test_baroclinic_rossby_wave_dispersion():
    """Mode-1 companion to the barotropic oracle: a single harmonic
    projected onto the first baroclinic eigenvector is also an exact
    nonlinear solution, with omega = -beta k/(k^2+l^2+1/Rd1^2).
    Validates the eigenmode machinery (modes.cm2l, rdm2) and the modal
    inversion against the analytic dispersion relation."""
    from qgcm_tpu.models.stepper import make_ocean_only_runner

    cfg = qc.ModelConfig(
        nxta=64, nyta=16, nxaooc=64, nyaooc=16, ndxr=1,
        fnot=9.4e-5, beta=1.75e-11, dta=200.0, nstr=3,
        ocean=qc.OceanConfig(nlo=3, dxo=10e3, delek=0.0,
                             hoc=(350., 750., 2900.),
                             gpoc=(0.025, 0.0125),
                             tabsoc=(287., 282., 276.),
                             ah2oc=(0., 0., 0.), ah4oc=(0., 0., 0.)),
        ocean_only=True, cyclic_ocean=True).validate()
    model = build_model(cfg)
    g = model.grids
    nxp, nyp = cfg.nxpo, cfg.nypo
    nx, ny = nxp - 1, nyp - 1
    dx = g.dxo
    kx = 2 * np.pi * 3 / (nx * dx)
    ly = np.pi / (ny * dx)
    x = np.arange(nxp) * dx
    y = np.arange(nyp) * dx
    amp = 1e-4 * cfg.fnot * dx * dx
    wave = amp * np.sin(ly * y)[:, None] * np.cos(kx * x)[None, :]
    mode1 = np.asarray(model.modes_oc.cm2l)[:, 1]    # layer weights
    state = init_ocean_state(model, po=mode1[:, None, None] * wave)
    forcing = ocean_forcing_from_mean(model, *zero_forcing(cfg))
    run = make_ocean_only_runner(model)

    # project the MODAL amplitude (cl2m) back out of the layers
    cl2m = np.asarray(model.modes_oc.cl2m)

    def phase(st):
        p1 = np.einsum("k,kyx->yx", cl2m[1], np.asarray(st.po))[:, :nx]
        cy = np.sin(ly * y)[:, None]
        c = (p1 * cy * np.cos(kx * x[:nx])[None, :]).sum()
        s = (p1 * cy * np.sin(kx * x[:nx])[None, :]).sum()
        return np.arctan2(s, c)

    # baroclinic waves are slow: measure over a longer window
    ths = [phase(state)]
    for _ in range(6):
        state = run(state, forcing, 300)
        ths.append(phase(state))
    omega = np.unwrap(np.diff(ths)).mean() / (300 * cfg.dto)
    rd2 = float(np.asarray(model.modes_oc.rdm2)[1])
    omega_ref = -cfg.beta * kx / (kx**2 + ly**2 + rd2)
    assert omega < 0
    assert abs(omega - omega_ref) < 0.05 * abs(omega_ref), \
        (omega, omega_ref)


def test_rossby_wave_dispersion_both_modes():
    """Quantitative linear-dynamics oracle: a small-amplitude Rossby
    wave in each vertical mode of an unforced, inviscid cyclic channel
    propagates westward at the DISCRETE dispersion prediction

        omega = beta * keff / (K2 + 1/Rd_m^2),
        keff = sin(k dx)/dx,
        K2   = (4/dx^2)(sin^2(k dx/2) + sin^2(l dx/2)),

    i.e. the linearisation of the Arakawa Jacobian's beta advection
    against the model's own modal inversion (reference physics:
    qgosubs.F Jacobian + ocisubs.F modal solve; the mode-m deformation
    radius enters exactly as eigmode.f's rdm2). Checks phase to 2% on
    BOTH modes (validating Rd via the baroclinic slowdown) and
    amplitude conservation to 1e-3 over ~0.7 rad of phase."""
    cfg = qc.ModelConfig(
        nxta=24, nyta=24, nxaooc=24, nyaooc=12, ndxr=4,
        fnot=5.92e-5, beta=2.08e-11, dta=150.0, nstr=3,
        ocean=qc.OceanConfig(
            nlo=2, dxo=10e3, delek=0.0, hoc=(800., 3200.),
            gpoc=(0.01,), tabsoc=(287., 282.),
            ah2oc=(0., 0.), ah4oc=(0., 0.)),
        ocean_only=True, cyclic_ocean=True).validate()
    model = build_model(cfg)
    nxpo, nypo, dxo = cfg.nxpo, cfg.nypo, cfg.ocean.dxo
    nxto = cfg.nxto
    kx, ly = 3, 1
    k = 2 * np.pi * kx / (nxto * dxo)
    l = np.pi * ly / ((nypo - 1) * dxo)
    x = np.arange(nxpo) * dxo
    y = np.arange(nypo) * dxo
    wave = 1e-4 * np.sin(l * y)[:, None] * np.cos(k * x)[None, :]
    cm2l = np.asarray(model.modes_oc.cm2l)
    cl2m = np.asarray(model.modes_oc.cl2m)
    rdm2 = np.asarray(model.modes_oc.rdm2)
    run = make_ocean_only_runner(model)
    forcing = ocean_forcing_from_mean(model, *zero_forcing(cfg))
    dto = cfg.nstr * cfg.dta
    n = 1600

    keff = np.sin(k * dxo) / dxo
    K2 = (4 / dxo**2) * (np.sin(k * dxo / 2)**2
                         + np.sin(l * dxo / 2)**2)
    # each leapfrog time-level averaging (every 25 substeps,
    # x <- (x+xm)/2) retards the phase by omega*dto/2
    n_avg = len(range(0, n, 25))
    t_eff = (n - 0.5 * n_avg) * dto

    for m in range(2):
        po = np.einsum("k,yx->kyx", cm2l[:, m], wave)
        st = init_ocean_state(model, po=po)
        out = run(st, forcing, n)

        def mode_amp(s):
            pm = np.einsum("k,kyx->yx", cl2m[m, :], np.asarray(s.po))
            return np.fft.rfft(pm[nypo // 2, :nxto])[kx]

        a0, a1 = mode_amp(st), mode_amp(out)
        dphi = np.angle(a1 / a0)
        dphi_pred = cfg.beta * keff / (K2 + rdm2[m]) * t_eff
        assert dphi > 0, f"mode {m} moved east"
        assert abs(dphi / dphi_pred - 1) < 0.02, (m, dphi, dphi_pred)
        assert abs(abs(a1) / abs(a0) - 1) < 1e-3, (m, abs(a1 / a0))
