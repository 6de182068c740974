"""Atmospheric component: mixed layer, QG vorticity step, PV inversion.

Replaces reference src/amlsubs.F (aml/amladf), src/qgasubs.F
(qgastep/atadif) and src/atisubs.F (atinvq) with one fused, functional
step. The atmosphere is always a zonally-cyclic channel.

Differences from the ocean component (models/ocean.py):
  * the mixed layer has a prognostic THICKNESS hmixa as well as a
    temperature, with a diabatic relaxation and min-thickness fixer
    (amlsubs.F:118-137);
  * advection uses Ekman velocity components uekat/vekat computed by
    xforc in addition to the geostrophic flow (amlsubs.F:246-531);
  * layer 1 is the BOTTOM layer: topography and entrainment act there,
    there is no bottom drag and no Del-sqd dissipation (qgasubs.F);
  * entrainment/windstress terms enter the momentum constraints with
    opposite signs (atisubs.F:160-180 vs ocisubs.F:174-193).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..model import Model
from ..ops.stencils import (del2_bc, jacobian9, _wshift, _eshift,
                            _row_mask)
from ..ops.integrals import xintp
from ..ops.vorticity import qcomp, atqzbd
from ..state import AtmosState, AtmosForcing
from .ocean import _pad_t_grid, _lap_padded, _line_sum_p, _entrain_to_p


class AtmosStepDiags(NamedTuple):
    ermasa: jnp.ndarray   # (nla-1,) continuity constraint error
    emfrat: jnp.ndarray   # (nla-1,) fractional error
    xan1: jnp.ndarray     # area integral of interface-1 entrainment
    cfraat: jnp.ndarray   # fraction of convecting a.m.l. points
    centat: jnp.ndarray   # integrated convective entrainment


# ----------------------------------------------------------------------
# Mixed layer (src/amlsubs.F)
# ----------------------------------------------------------------------

def _amladf(model: Model, ast, astm, hmixa, hmixam, pa1,
            forcing: AtmosForcing):
    """Advective + diffusive RHS of the AST and hmixa equations
    (amladf, src/amlsubs.F:246-560). C-grid advection by geostrophic
    + Ekman flow; AST has Del-sqd and Del-4th diffusion with no-flux
    zonal boundaries; hmixa has Del-sqd diffusion with hmixa = hmat
    outside the zonal boundaries."""
    cfg = model.cfg
    g = model.grids
    rdxaf0 = 1.0 / (g.dxa * cfg.fnot)
    hdxam1 = 0.5 / g.dxa
    d2tfac = cfg.mixed.at2d / g.dxa**2
    d4tfac = cfg.mixed.at4d / g.dxa**4
    hmdfac = cfg.mixed.ahmd / g.dxa**2
    hmat = cfg.mixed.hmat

    # u at T-cell W/E faces (nyta, nxpa): faces line up with p columns.
    # Same formula on all rows incl. zonal boundaries (amlsubs.F:391).
    uface = -rdxaf0 * (pa1[1:, :] - pa1[:-1, :]) + forcing.uekat

    def tsum_x(f):
        wrap = f[:, :1] + f[:, -1:]
        return jnp.concatenate([wrap, f[:, :-1] + f[:, 1:], wrap], axis=1)

    xflux_t = uface * tsum_x(ast)
    xflux_h = uface * tsum_x(hmixa)
    xadvt = hdxam1 * (xflux_t[:, 1:] - xflux_t[:, :-1])
    xadvh = hdxam1 * (xflux_h[:, 1:] - xflux_h[:, :-1])

    # v at T-cell S/N faces (nypa, nxta). On the zonal walls p is
    # constant along the row so the geostrophic part vanishes; the
    # reference uses the Ekman part only there (amlsubs.F:398,418).
    vgeo = rdxaf0 * (pa1[:, 1:] - pa1[:, :-1])
    walls = _row_mask(forcing.vekat, 0) | _row_mask(forcing.vekat, -1)
    vface = jnp.where(walls, forcing.vekat, vgeo + forcing.vekat)

    # temperature: no normal heat flux through the walls
    tyf = jnp.concatenate(
        [jnp.zeros_like(ast[:1]), ast[:-1, :] + ast[1:, :],
         jnp.zeros_like(ast[:1])], axis=0)
    yflux_t = jnp.where(walls, 0.0, vface * tyf)
    yadvt = hdxam1 * (yflux_t[1:, :] - yflux_t[:-1, :])

    # thickness: normal flux allowed, hmixa = hmat outside the walls
    hyf = jnp.concatenate(
        [hmat + hmixa[:1], hmixa[:-1, :] + hmixa[1:, :],
         hmat + hmixa[-1:]], axis=0)
    yflux_h = vface * hyf
    yadvh = hdxam1 * (yflux_h[1:, :] - yflux_h[:-1, :])

    # AST diffusion on the lagged field (cyclic x, no-flux y)
    del2t = _lap_padded(_pad_t_grid(astm, True))
    del4t = _lap_padded(_pad_t_grid(del2t, True))
    tmrhs = -(xadvt + yadvt) + d2tfac * del2t - d4tfac * del4t

    # hmixa diffusion: ghost rows hold hmat (amlsubs.F:406-409)
    hx = jnp.concatenate([hmixam[:, -1:], hmixam, hmixam[:, :1]],
                         axis=1)
    grow = jnp.full_like(hx[:1], hmat)
    hmixam_p = jnp.concatenate([grow, hx, grow], axis=0)
    hmrhs = -(xadvh + yadvh) + hmdfac * _lap_padded(hmixam_p)
    return tmrhs, hmrhs


def _aml(model: Model, state: AtmosState, forcing: AtmosForcing):
    """Step the atmospheric mixed layer (aml, src/amlsubs.F:47-240).
    Returns (ast, astm, hmixa, hmixam, entat, xan1, enis1, enin1,
    cfraat, centat).

    On float32 models the AST/hmixa PREDICTION + clamp chain runs in
    FLOAT64 by default (store stays f32; config.ml_f64): the
    min-thickness fixer and the diabatic-limit branches are non-smooth
    switches of the same class as the ocean SST convection clamp,
    which measurably decouples the f32 leapfrog time levels at a
    switching front and runs away (see models/ocean._oml). The
    stencil-heavy RHS (_amladf), the entrainment fields and the
    reductions stay in the storage dtype -- the same measured
    sufficient split as the ocean. The f64 reference never sees the
    regime."""
    cfg = model.cfg
    g = model.grids
    sdt = state.ast.dtype
    tat = [float(t) for t in model.rad.tat]
    tdta = 2.0 * cfg.dta
    hmat = cfg.mixed.hmat
    hmainv = 1.0 / hmat
    rrcpat = 1.0 / (cfg.rhoat * cfg.cpat)
    hdrcdt = cfg.mixed.hmadmp * rrcpat * tdta
    diabcr = tat[0] - 2.0 * hdrcdt
    entfac = 1.0 / (tdta * (tat[1] - tat[0]))
    xbfac = cfg.xcexp * model.rad.bface
    cface = model.rad.cface
    dface = model.rad.dface
    afacdp = (jnp.asarray(model.rad.aface, dtype=state.pa.dtype)
              / jnp.asarray(cfg.atmos.gpat, dtype=state.pa.dtype))
    xc1ast = ((1.0 - cfg.xcexp)
              * jnp.asarray(model.rad.astbar, dtype=sdt))[:, None]

    tmrhs, hmrhs = _amladf(model, state.ast, state.astm, state.hmixa,
                           state.hmixam, state.pa[0], forcing)

    from ..config import ml_f64_enabled
    ct = (jnp.float64 if ml_f64_enabled(cfg) and sdt == jnp.float32
          else sdt)
    astm, hmixam = state.astm.astype(ct), state.hmixam.astype(ct)

    # hmixa prediction (7.16) with min-thickness fixer, in `ct`
    diab = astm <= diabcr
    denom = jnp.where(diab, tat[0] - astm, 1.0)
    dhdiab = hdrcdt * (hmixam - hmat) / denom
    hnew0 = hmixam + tdta * hmrhs.astype(ct) - dhdiab
    dhfix = jnp.maximum(cfg.mixed.hmamin - hnew0, 0.0)
    hnew = jnp.where(diab, hnew0 + dhfix, hmat).astype(sdt)
    dtfix = jnp.where(diab, dhfix * (tat[0] - astm) / hmixam, 0.0)

    # AST prediction (7.17), in `ct`
    trhtot = (tmrhs.astype(ct)
              + rrcpat * forcing.fnetat.astype(ct) / hmixam
              - hmainv * forcing.wekta.astype(ct) * astm)
    astnew = astm + tdta * trhtot + dtfix
    dtanew = tat[0] - astnew
    astnew = (astnew + jnp.minimum(0.0, dtanew)).astype(sdt)
    dtanew = dtanew.astype(sdt)
    astm, hmixam = state.astm, state.hmixam

    # Entrainment across interface 1 at T points (7.18), then
    # convective correction (7.19) -- storage dtype
    xfaent = xbfac * (hmixam - hmat) + dface * (cfg.xcexp * astm + xc1ast)
    conena = entfac * state.hmixa * jnp.minimum(0.0, dtanew)
    xfa = xfaent - cfg.xcexp * conena

    cfraat = jnp.mean(jnp.where(dtanew < 0.0, 1.0, 0.0))
    centat = -jnp.sum(conena) * g.dxa * g.dya

    # Average onto p points; add eta + topography terms evaluated there
    entat = _entrain_to_p(xfa, True)
    delpm = state.pam[:-1] - state.pam[1:]          # (nla-1, nypa, nxpa)
    entat = entat + jnp.einsum("l,lyx->yx", afacdp, delpm,
                               precision="highest")
    entat = entat + cface * model.topo.dtopat_or_scalar(entat.dtype)

    xan1 = xintp(entat) * g.dxa * g.dya
    enis1 = g.dxa * _line_sum_p(entat[0, :])
    enin1 = g.dxa * _line_sum_p(entat[-1, :])
    return (astnew, state.ast, hnew, state.hmixa, entat, xan1,
            enis1, enin1, cfraat, centat)


# ----------------------------------------------------------------------
# QG vorticity step (src/qgasubs.F)
# ----------------------------------------------------------------------

def _qgastep(model: Model, state: AtmosState, forcing: AtmosForcing,
             entat: jnp.ndarray):
    """Leapfrog step of the atmospheric PV equation (7.14).
    Channel geometry, Del-4th dissipation only, no bottom drag."""
    cfg = model.cfg
    g = model.grids
    dxam2 = 1.0 / g.dxa**2
    adfaca = 1.0 / (12.0 * g.dxa * g.dya * cfg.fnot)
    zbfaca = cfg.atmos.bccoat * dxam2 / (0.5 * cfg.atmos.bccoat + 1.0)
    fohfac = jnp.asarray([cfg.fnot / h for h in cfg.atmos.hat],
                         dtype=state.pa.dtype)
    ah4 = jnp.asarray(cfg.atmos.ah4at, dtype=state.pa.dtype)
    tdta = 2.0 * cfg.dta

    pa, pam, qa, qam = state.pa, state.pam, state.qa, state.qam

    del2p = del2_bc(pam, zbfaca, dxam2, True)
    d4p = del2_bc(del2p, zbfaca, dxam2, True)
    zonal = _row_mask(pa[0], 0) | _row_mask(pa[0], -1)
    d4w, d4e = _wshift(d4p), _eshift(d4p)
    d4pp = jnp.pad(d4p, [(0, 0), (1, 1), (0, 0)])
    d6p = dxam2 * (d4pp[:, :-2, :] + d4pp[:, 2:, :] + d4w + d4e
                   - 4.0 * d4p)
    d6full = jnp.where(zonal, 0.0, d6p)

    jac = jacobian9(qa, pa, True)
    lhot = jnp.eye(cfg.nla, dtype=pa.dtype)[:, :, None, None]
    qdot = (adfaca * jac - (ah4[:, None, None] / cfg.fnot) * d6full
            + lhot[0] * (fohfac[0] * (entat - forcing.wekpa))
            - lhot[1] * (fohfac[1] * entat))

    qa_new = qam + tdta * qdot
    qa_new = jnp.where(zonal, qa, qa_new)
    qam_new = qa

    # Boundary constraint integrals (atadif, qgasubs.F:186-218,294-318)
    pe, pw = _eshift(pa), _wshift(pa)
    pdx_s = (pe - pw)[:, 1, :]
    pdx_n = (pe - pw)[:, -2, :]
    wend = jnp.ones(pa.shape[-1], dtype=pa.dtype).at[0].set(0.5) \
        .at[-1].set(0.5)
    aj5s = jnp.sum(wend * qa[:, 0, :] * pdx_s, axis=-1)
    aj9s = jnp.sum(wend * qa[:, 1, :] * pdx_s, axis=-1)
    aj5n = -jnp.sum(wend * qa[:, -1, :] * pdx_n, axis=-1)
    aj9n = -jnp.sum(wend * qa[:, -2, :] * pdx_n, axis=-1)
    ajis = cfg.fnot * adfaca * (aj5s + 2.0 * aj9s) * g.dxa * g.dya
    ajin = cfg.fnot * adfaca * (aj5n + 2.0 * aj9n) * g.dxa * g.dya

    ap5s = ah4 * jnp.sum(d4p[:, 1, :-1] - d4p[:, 0, :-1], axis=-1)
    ap5n = ah4 * jnp.sum(d4p[:, -1, :-1] - d4p[:, -2, :-1], axis=-1)

    cyc = dict(ajis=ajis, ajin=ajin, ap5s=ap5s, ap5n=ap5n)
    return qa_new, qam_new, cyc


# ----------------------------------------------------------------------
# PV inversion (src/atisubs.F atinvq)
# ----------------------------------------------------------------------

def _atinvq(model: Model, state: AtmosState, qa_new: jnp.ndarray,
            xan1, enis1, enin1, cyc, forcing: AtmosForcing):
    """Invert PV to pressure; apply channel momentum + mass constraints.
    Mirrors the cyclic-ocean inversion with atmospheric signs
    (atisubs.F:160-180): entrainment and windstress enter with the
    opposite sign because layer 1 is at the BOTTOM of the fluid."""
    cfg = model.cfg
    g = model.grids
    inv = model.inv_at
    nla = cfg.nla
    dtype = state.pa.dtype
    tdta = 2.0 * cfg.dta
    cl2m = jnp.asarray(model.modes_at.cl2m, dtype=dtype)
    cm2l = jnp.asarray(model.modes_at.cm2l, dtype=dtype)
    gpat = jnp.asarray(cfg.atmos.gpat, dtype=dtype)
    hat = jnp.asarray(cfg.atmos.hat, dtype=dtype)
    ddyn = model.topo.ddynat_or_scalar(dtype)
    betay = (cfg.beta * jnp.asarray(g.yparel, dtype=dtype))[None, :, None]

    kb = jnp.eye(nla, dtype=dtype)[0][:, None, None]
    ql = qa_new - betay - kb * ddyn
    wrk = cfg.fnot * jnp.einsum("mk,kyx->myx", cl2m, ql,
                                precision="highest")

    sol = inv.helm.solve(wrk)
    xinhom = xintp(sol) * g.dxa * g.dya

    ecrita = 1.0e-13
    entfac = 0.5 * g.dya * cfg.fnot**2
    enis = jnp.zeros(nla - 1, dtype=dtype).at[0].set(enis1)
    enin = jnp.zeros(nla - 1, dtype=dtype).at[0].set(enin1)
    ent_s = jnp.concatenate([enis, jnp.zeros((1,), dtype)])
    ent_sm = jnp.concatenate([jnp.zeros((1,), dtype), enis])
    ent_n = jnp.concatenate([enin, jnp.zeros((1,), dtype)])
    ent_nm = jnp.concatenate([jnp.zeros((1,), dtype), enin])
    rhss = -(entfac / hat) * (ent_s - ent_sm) + cyc["ajis"] + cyc["ap5s"]
    rhsn = -(entfac / hat) * (ent_n - ent_nm) + cyc["ajin"] - cyc["ap5n"]
    rhss = rhss.at[0].add(-(cfg.fnot / hat[0]) * forcing.txisat)
    rhsn = rhsn.at[0].add((cfg.fnot / hat[0]) * forcing.txinat)

    atsnew = state.atmcsp + tdta * rhss
    atnnew = state.atmcnp + tdta * rhsn
    atmcsp_new, atmcnp_new = state.atmcs, state.atmcn
    atmcs_new, atmcn_new = atsnew, atnnew

    ayis = _line_sum_p(sol[:, 1, :]) * (g.dxa / g.dya)
    ayin = -_line_sum_p(sol[:, -2, :]) * (g.dxa / g.dya)
    clhss = jnp.matmul(cl2m, atsnew, precision="highest") + ayis
    clhsn = jnp.matmul(cl2m, atnnew, precision="highest") - ayin

    c3 = clhss[0] * inv.hbsiat
    c1 = inv.hc2n * clhss[1:] - inv.hc2s * clhsn[1:]
    c2 = inv.hc1s * clhsn[1:] - inv.hc1n * clhss[1:]

    aipmod = xinhom.at[0].add(c3 * inv.aipbha)
    aipmod = aipmod.at[1:].add((c1 + c2) * inv.aipcha)
    aiplay = jnp.matmul(cm2l, aipmod, precision="highest")

    aient = jnp.zeros(nla - 1, dtype=dtype).at[0].set(xan1)
    est1 = aiplay[:-1] - aiplay[1:]
    est2 = state.dpiatp - tdta * gpat * aient
    edif = est1 - est2
    esum = jnp.abs(est1) + jnp.abs(est2)
    ermasa = edif
    thresh = ecrita * g.xla * g.yla * tdta * gpat
    emfrat = jnp.where(esum > thresh, 2.0 * edif / esum, 0.0)
    dpiatp_new = state.dpiat
    dpiat_new = est1

    homcor = jnp.concatenate([
        (c3 * inv.pbhat)[None, :],
        c1[:, None] * inv.pch1at + c2[:, None] * inv.pch2at,
    ], axis=0)
    pm = sol + homcor[:, :, None]
    pa_new = jnp.einsum("km,myx->kyx", cm2l, pm, precision="highest")
    return (pa_new, state.pa, dpiat_new, dpiatp_new,
            atmcs_new, atmcn_new, atmcsp_new, atmcnp_new,
            ermasa, emfrat)


# ----------------------------------------------------------------------
# Full step + init helpers
# ----------------------------------------------------------------------

def make_atmos_step(model: Model):
    """Build the fused atmospheric step:
    aml -> qgastep -> atinvq -> atqzbd (main loop q-gcm.F:1259-1268)."""
    cfg = model.cfg
    dtype = jnp.dtype(cfg.dtype)
    dxam2 = 1.0 / model.grids.dxa**2
    amat = np.asarray(model.modes_at.amat, dtype=dtype)
    yparel = np.asarray(model.grids.yparel, dtype=dtype)
    ddyn = model.topo.ddynat_or_scalar(dtype)

    def step(state: AtmosState, forcing: AtmosForcing):
        (ast_new, astm_new, hmixa_new, hmixam_new, entat, xan1,
         enis1, enin1, cfraat, centat) = _aml(model, state, forcing)

        qa_new, qam_new, cyc = _qgastep(model, state, forcing, entat)

        (pa_new, pam_new, dpiat, dpiatp, atmcs, atmcn, atmcsp, atmcnp,
         ermasa, emfrat) = _atinvq(model, state, qa_new, xan1,
                                   enis1, enin1, cyc, forcing)

        qa_new = atqzbd(qa_new, pa_new, amat, yparel, dxam2, cfg.fnot,
                        cfg.beta, cfg.atmos.bccoat, ddyn)

        new_state = AtmosState(
            pa=pa_new, pam=pam_new, qa=qa_new, qam=qam_new,
            ast=ast_new, astm=astm_new,
            hmixa=hmixa_new, hmixam=hmixam_new,
            dpiat=dpiat, dpiatp=dpiatp,
            atmcs=atmcs, atmcn=atmcn, atmcsp=atmcsp, atmcnp=atmcnp)
        diags = AtmosStepDiags(ermasa=ermasa, emfrat=emfrat, xan1=xan1,
                               cfraat=cfraat, centat=centat)
        return new_state, diags

    return step


def init_atmos_state(model: Model, init: str = "rbal",
                     pa=None, pam=None, ast=None, astm=None,
                     hmixa=None, hmixam=None) -> AtmosState:
    """Initial atmospheric state: 'zero' (zeroin, q-gcm.F:1615), 'rbal'
    (rbalin, q-gcm.F:1712: pa from the radiative-balance eta coeffts
    plfac, ast = astbar, hmixa = hmat), or explicit arrays."""
    cfg = model.cfg
    g = model.grids
    dtype = jnp.dtype(cfg.dtype)
    nla, nypa, nxpa = cfg.nla, cfg.nypa, cfg.nxpa
    nyta, nxta = cfg.nyta, cfg.nxta
    import numpy as np

    if pa is None:
        if init == "rbal":
            # plfac(1)=0; plfac(k) = plfac(k-1) - gpat(k-1)*rbetat(k-1)
            plfac = np.zeros(nla)
            for k in range(1, nla):
                plfac[k] = (plfac[k - 1]
                            - cfg.atmos.gpat[k - 1] * model.rad.rbetat[k - 1])
            from ..radiation import fsprim
            prof = fsprim(cfg, model.rad.fspco, g.yparel)     # (nypa,)
            pa = np.broadcast_to(
                (plfac[:, None] * prof[None, :])[:, :, None],
                (nla, nypa, nxpa)).copy()
        else:
            pa = np.zeros((nla, nypa, nxpa))
    pa = jnp.asarray(pa, dtype=dtype)
    pam = pa if pam is None else jnp.asarray(pam, dtype=dtype)

    if ast is None:
        if init == "rbal":
            ast = jnp.broadcast_to(
                jnp.asarray(model.rad.astbar, dtype=dtype)[:, None],
                (nyta, nxta))
        else:
            ast = jnp.zeros((nyta, nxta), dtype=dtype)
    else:
        ast = jnp.asarray(ast, dtype=dtype)
    astm = ast if astm is None else jnp.asarray(astm, dtype=dtype)
    if hmixa is None:
        hmixa = jnp.full((nyta, nxta), cfg.mixed.hmat, dtype=dtype)
    else:
        hmixa = jnp.asarray(hmixa, dtype=dtype)
    hmixam = hmixa if hmixam is None else jnp.asarray(hmixam, dtype=dtype)

    amat = jnp.asarray(model.modes_at.amat, dtype=dtype)
    yparel = jnp.asarray(g.yparel, dtype=dtype)
    ddyn = model.topo.ddynat_or_scalar(dtype)
    dxam2 = 1.0 / g.dxa**2

    def q_from_p(p):
        q = qcomp(p, amat, yparel, dxam2, cfg.fnot, cfg.beta, ddyn,
                  0, True)
        return atqzbd(q, p, amat, yparel, dxam2, cfg.fnot, cfg.beta,
                      cfg.atmos.bccoat, ddyn)

    qa = q_from_p(pa)
    qam = q_from_p(pam)

    # constr (conhoms.F:203-310)
    area = g.dxa * g.dya
    dpiat = xintp(pa[:-1] - pa[1:]) * area
    dpiatp = xintp(pam[:-1] - pam[1:]) * area

    fsq = 0.5 * g.dya * cfg.fnot**2

    def momcon(p):
        pins = g.dxa * _line_sum_p(p[:, 0, :])
        pinn = g.dxa * _line_sum_p(p[:, -1, :])
        cs = _line_sum_p(p[:, 1, :] - p[:, 0, :]) * (g.dxa / g.dya)
        cn = _line_sum_p(p[:, -1, :] - p[:, -2, :]) * (g.dxa / g.dya)
        cs = -cs + fsq * jnp.matmul(amat, pins,
                                    precision="highest")
        cn = cn + fsq * jnp.matmul(amat, pinn,
                                    precision="highest")
        return cs, cn

    atmcs, atmcn = momcon(pa)
    atmcsp, atmcnp = momcon(pam)

    return AtmosState(pa=pa, pam=pam, qa=qa, qam=qam,
                      ast=ast, astm=astm, hmixa=hmixa, hmixam=hmixam,
                      dpiat=dpiat, dpiatp=dpiatp,
                      atmcs=atmcs, atmcn=atmcn,
                      atmcsp=atmcsp, atmcnp=atmcnp)
