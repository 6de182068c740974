"""Oceanic component: mixed layer, QG vorticity step, PV inversion.

Replaces reference src/omlsubs.F (oml/omladf), src/qgosubs.F
(qgostep/ocadif) and src/ocisubs.F (ocinvq) with one fused, functional
substep. Everything is jnp under jit; a whole ocean substep is a single
XLA computation (the reference forks ~20 OpenMP regions per substep).

Equation references are to the Q-GCM v1.5.0 users' guide numbering used
in the reference source comments (7.x).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..config import ModelConfig
from ..model import Model
from ..ops.stencils import (del2_bc, jacobian9, interior_5pt, _wshift,
                            _eshift, _row_mask, _col_mask)
from ..ops.integrals import xintp
from ..ops.vorticity import qcomp, ocqbdy
from ..state import OceanState, OceanForcing


class OceanStepDiags(NamedTuple):
    """Per-step cheap diagnostics (monitoring subset)."""
    ermaso: jnp.ndarray   # (nlo-1,) continuity constraint error (cyclic)
    emfroc: jnp.ndarray   # (nlo-1,) fractional error
    xon1: jnp.ndarray     # scalar: area integral of layer-1/2 entrainment
    cfraoc: jnp.ndarray   # scalar: fraction of convecting o.m.l. points
    centoc: jnp.ndarray   # scalar: integrated convective entrainment


def _line_sum_p(row: jnp.ndarray) -> jnp.ndarray:
    """Sum along a p-grid boundary row with 1/2 weights at the two ends
    (the reference's repeated 0.5*f(1) + sum + 0.5*f(nxp) pattern)."""
    return row[..., 1:-1].sum(axis=-1) + 0.5 * (row[..., 0] + row[..., -1])


def _pad_t_grid(f: jnp.ndarray, cyclic: bool, south=None, north=None):
    """Pad a T-grid field by one ghost cell on each side.
    x: wraparound (cyclic) or edge-replicate (no normal flux).
    y: edge-replicate (no flux) unless a constant boundary value is
    given (sb_hflux/nb_hflux specified-temperature conditions)."""
    if cyclic:
        f = jnp.concatenate([f[:, -1:], f, f[:, :1]], axis=1)
    else:
        f = jnp.concatenate([f[:, :1], f, f[:, -1:]], axis=1)
    srow = f[:1] if south is None else jnp.full_like(f[:1], south)
    nrow = f[-1:] if north is None else jnp.full_like(f[-1:], north)
    return jnp.concatenate([srow, f, nrow], axis=0)


def _lap_padded(fp: jnp.ndarray) -> jnp.ndarray:
    """Unscaled 5-point stencil sum of a ghost-padded field."""
    return (fp[:-2, 1:-1] + fp[2:, 1:-1] + fp[1:-1, :-2] + fp[1:-1, 2:]
            - 4.0 * fp[1:-1, 1:-1])


# ----------------------------------------------------------------------
# Mixed layer (src/omlsubs.F)
# ----------------------------------------------------------------------

def _omladf(model: Model, sst, sstm, po1, tauxo, tauyo):
    """Advective + diffusive RHS of the SST equation (omladf,
    src/omlsubs.F:244-763). 2nd-order C-grid advection of sst by
    geostrophic + Ekman velocities, del2 and del4 diffusion of sstm."""
    cfg = model.cfg
    g = model.grids
    cyclic = cfg.cyclic_ocean
    uvgfac = cfg.ycexp / (g.dxo * cfg.fnot)
    rhf0hm = 0.5 / (cfg.fnot * cfg.mixed.hmoc)
    hdxom1 = 0.5 / g.dxo
    d2tfac = cfg.mixed.st2d / g.dxo**2
    d4tfac = cfg.mixed.st4d / g.dxo**4
    tsbdy, tnbdy = model.rad.tsbdy, model.rad.tnbdy

    # u at T-cell W/E faces: faces line up with p columns. (nyto, nxpo)
    uface = (-uvgfac * (po1[1:, :] - po1[:-1, :])
             + rhf0hm * (tauyo[1:, :] + tauyo[:-1, :]))
    # T at W/E faces (sum of adjacent cells; the 1/2 is in hdxom1)
    if cyclic:
        twrap = (sst[:, :1] + sst[:, -1:])
        tface = jnp.concatenate(
            [twrap, sst[:, :-1] + sst[:, 1:], twrap], axis=1)
        xflux = uface * tface
    else:
        tface = jnp.concatenate(
            [jnp.zeros_like(sst[:, :1]), sst[:, :-1] + sst[:, 1:],
             jnp.zeros_like(sst[:, :1])], axis=1)
        xflux = uface * tface
        wecols = _col_mask(uface, 0) | _col_mask(uface, -1)
        xflux = jnp.where(wecols, 0.0, xflux)
    hxadv = hdxom1 * (xflux[:, 1:] - xflux[:, :-1])

    # v at T-cell S/N faces: faces line up with p rows. (nypo, nxto)
    vface = (uvgfac * (po1[:, 1:] - po1[:, :-1])
             - rhf0hm * (tauxo[:, 1:] + tauxo[:, :-1]))
    tyface = jnp.concatenate(
        [jnp.zeros_like(sst[:1]), sst[:-1, :] + sst[1:, :],
         jnp.zeros_like(sst[:1])], axis=0)
    yflux = vface * tyface
    srow, nrow = _row_mask(vface, 0), _row_mask(vface, -1)
    if cfg.sb_hflux:
        vs = -rhf0hm * (tauxo[0, 1:] + tauxo[0, :-1])
        yflux = jnp.where(srow, (vs * (sst[0, :] + tsbdy))[None, :],
                          yflux)
    else:
        yflux = jnp.where(srow, 0.0, yflux)
    if cfg.nb_hflux:
        vn = -rhf0hm * (tauxo[-1, 1:] + tauxo[-1, :-1])
        yflux = jnp.where(nrow, (vn * (sst[-1, :] + tnbdy))[None, :],
                          yflux)
    else:
        yflux = jnp.where(nrow, 0.0, yflux)
    hyadv = hdxom1 * (yflux[1:, :] - yflux[:-1, :])

    rhs = -(hxadv + hyadv)

    # del2 of lagged SST with no-flux (or specified-T) boundaries
    sstm_p = _pad_t_grid(
        sstm, cyclic,
        south=tsbdy if cfg.sb_hflux else None,
        north=tnbdy if cfg.nb_hflux else None)
    del2t = _lap_padded(sstm_p)
    # del4: second application, always no-flux in y (omlsubs.F:748-758)
    del2t_p = _pad_t_grid(del2t, cyclic)
    del4t = _lap_padded(del2t_p)
    return rhs + d2tfac * del2t - d4tfac * del4t


def _entrain_to_p(xfo: jnp.ndarray, cyclic: bool) -> jnp.ndarray:
    """Average T-grid entrainment onto p points, conserving the area
    integral (omlsubs.F:158-206). Ghost padding (wraparound cyclic /
    edge-replicate solid) makes the reference's half and quarter edge
    and corner weights fall out of a single fused 4-point average."""
    if cyclic:
        xp = jnp.concatenate([xfo[:, -1:], xfo, xfo[:, :1]], axis=1)
    else:
        xp = jnp.concatenate([xfo[:, :1], xfo, xfo[:, -1:]], axis=1)
    xp = jnp.concatenate([xp[:1], xp, xp[-1:]], axis=0)
    return 0.25 * (xp[:-1, :-1] + xp[:-1, 1:] + xp[1:, :-1] + xp[1:, 1:])


def boundary_flux_diags(model: Model, state: OceanState,
                        forcing: OceanForcing):
    """Mean advective/diffusive SST fluxes through the modified
    sb_hflux / nb_hflux boundaries and the mean Ekman outflow velocity
    (monitoring section of omladf, src/omlsubs.F:684-727; +ve into the
    domain). Zeros when the modified conditions are inactive."""
    cfg = model.cfg
    g = model.grids
    dtype = state.sst.dtype
    z = jnp.zeros((), dtype)
    ttmads = vfmads = ttmdfs = ttmadn = vfmadn = ttmdfn = z
    rhf0hm = 0.5 / (cfg.fnot * cfg.mixed.hmoc)
    hdxom1 = 0.5 / g.dxo
    d2tfac = cfg.mixed.st2d / g.dxo**2
    nxto = cfg.nxto
    if cfg.sb_hflux:
        tsbdy = model.rad.tsbdy
        vm = -rhf0hm * (forcing.tauxo[0, 1:] + forcing.tauxo[0, :-1])
        tm = state.sst[0, :] + tsbdy
        ttmads = hdxom1 * jnp.sum(vm * tm) / nxto
        vfmads = jnp.sum(vm) / nxto
        ttmdfs = -d2tfac * jnp.sum(state.sstm[0, :] - tsbdy) / nxto
    if cfg.nb_hflux:
        tnbdy = model.rad.tnbdy
        vp = -rhf0hm * (forcing.tauxo[-1, 1:] + forcing.tauxo[-1, :-1])
        tp = state.sst[-1, :] + tnbdy
        ttmadn = -hdxom1 * jnp.sum(vp * tp) / nxto
        vfmadn = -jnp.sum(vp) / nxto
        ttmdfn = d2tfac * jnp.sum(tnbdy - state.sstm[-1, :]) / nxto
    return dict(ttmads=ttmads, vfmads=vfmads, ttmdfs=ttmdfs,
                ttmadn=ttmadn, vfmadn=vfmadn, ttmdfn=ttmdfn)


def _oml(model: Model, state: OceanState, forcing: OceanForcing):
    """Step the ocean mixed layer (oml, src/omlsubs.F:47-236).
    Returns (sst_new, sstm_new, entoc, xon1, enis1, enin1, conv diags).

    On float32 models the SST PREDICTION + CONVECTION CLAMP chain runs
    in FLOAT64 by default (store stays f32; config.ml_f64): the
    convection clamp is a non-smooth switch, and under f32 roundoff it
    can decouple the SST leapfrog time levels at a convecting front,
    after which the advection-diffusion runs away explosively (9 K ->
    NaN within 160 steps measured at a forced-channel front; the same
    state continued in f64 stays bounded). Promoting JUST this
    elementwise chain is measured sufficient to remove the runaway
    (round-5 notes); the stencil-heavy RHS, the entrainment fields and
    all reductions stay in the storage dtype, so the cost is a handful
    of f64 elementwise ops. The Fortran reference is double precision
    throughout and never sees the regime."""
    cfg = model.cfg
    sdt = state.sst.dtype
    toc = [float(t) for t in model.rad.toc]   # python floats: weak-typed
    tdto = 2.0 * cfg.dto
    hmoinv = 1.0 / cfg.mixed.hmoc
    dtoinv = 1.0 / (toc[0] - toc[1])
    entfac = cfg.mixed.hmoc * dtoinv / tdto
    rrcpoc = 1.0 / (cfg.rhooc * cfg.cpoc)

    rhs = _omladf(model, state.sst, state.sstm, state.po[0],
                  forcing.tauxo, forcing.tauyo)

    from ..config import ml_f64_enabled
    ct = (jnp.float64 if ml_f64_enabled(cfg) and sdt == jnp.float32
          else sdt)

    # SST prediction (7.11) + convection clamp (7.13) in `ct`
    diabat = 0.5 * forcing.wekto.astype(ct) * (state.sstm.astype(ct)
                                               + toc[0])
    sstnew = state.sstm.astype(ct) + tdto * (
        rhs.astype(ct)
        + hmoinv * (rrcpoc * forcing.fnetoc.astype(ct) + diabat))
    dtonew = toc[0] - sstnew
    conv = jnp.maximum(0.0, dtonew)
    sstnew = (sstnew + conv).astype(sdt)
    conv = conv.astype(sdt)
    dtonew = dtonew.astype(sdt)

    # entrainment (7.12) and everything downstream in the storage dtype
    xfoent = -(0.5 * dtoinv) * forcing.wekto * (state.sstm - toc[0])
    coneno = entfac * conv
    xfo = xfoent - coneno

    cfraoc = jnp.mean(jnp.where(dtonew > 0.0, 1.0, 0.0))
    centoc = -jnp.sum(coneno) * model.grids.dxo * model.grids.dyo

    # Remove mean so net entrainment (deep-ocean heat flux) is zero
    xfo = xfo - jnp.sum(xfo) * cfg.ocnorm

    entoc = _entrain_to_p(xfo, cfg.cyclic_ocean)
    xon1 = xintp(entoc) * model.grids.dxo * model.grids.dyo

    # Boundary entrainment integrals for cyclic momentum constraints
    enis1 = model.grids.dxo * _line_sum_p(entoc[0, :])
    enin1 = model.grids.dxo * _line_sum_p(entoc[-1, :])
    return sstnew, state.sst, entoc, xon1, enis1, enin1, cfraoc, centoc


# ----------------------------------------------------------------------
# QG vorticity step (src/qgosubs.F)
# ----------------------------------------------------------------------

def _qgostep(model: Model, state: OceanState, forcing: OceanForcing,
             entoc: jnp.ndarray):
    """Leapfrog step of the PV equation (7.14). Returns
    (qo_new, qom_new, and the cyclic boundary-constraint integrals)."""
    cfg = model.cfg
    g = model.grids
    cyclic = cfg.cyclic_ocean
    nlo = cfg.nlo
    dxom2 = 1.0 / g.dxo**2
    adfaco = 1.0 / (12.0 * g.dxo * g.dyo * cfg.fnot)
    bcfaco = cfg.ocean.bccooc * dxom2 / (0.5 * cfg.ocean.bccooc + 1.0)
    fohfac = jnp.asarray(
        [cfg.fnot / h for h in cfg.ocean.hoc], dtype=state.po.dtype)
    bdrfac = 0.5 * jnp.sign(cfg.fnot) * cfg.ocean.delek / cfg.ocean.hoc[-1]
    ah2 = jnp.asarray(cfg.ocean.ah2oc, dtype=state.po.dtype)
    ah4 = jnp.asarray(cfg.ocean.ah4oc, dtype=state.po.dtype)
    tdto = 2.0 * cfg.dto

    po, pom, qo, qom = state.po, state.pom, state.qo, state.qom

    # Dissipation operates on the LAGGED pressure (qgosubs.F:88-130)
    del2p = del2_bc(pom, bcfaco, dxom2, cyclic)
    d4p = del2_bc(del2p, bcfaco, dxom2, cyclic)
    zonal = _row_mask(po[0], 0) | _row_mask(po[0], -1)
    if cyclic:
        d4w, d4e = _wshift(d4p), _eshift(d4p)
        d4pp = jnp.pad(d4p, [(0, 0), (1, 1), (0, 0)])
        d6p = dxom2 * (d4pp[:, :-2, :] + d4pp[:, 2:, :] + d4w + d4e
                       - 4.0 * d4p)
        d6full = jnp.where(zonal, 0.0, d6p)
        edge = zonal
    else:
        d4pp = jnp.pad(d4p, [(0, 0), (1, 1), (1, 1)])
        d6p = dxom2 * (d4pp[:, :-2, 1:-1] + d4pp[:, 2:, 1:-1]
                       + d4pp[:, 1:-1, :-2] + d4pp[:, 1:-1, 2:]
                       - 4.0 * d4p)
        edge = zonal | _col_mask(po[0], 0) | _col_mask(po[0], -1)
        d6full = jnp.where(edge, 0.0, d6p)

    jac = jacobian9(qo, po, cyclic)
    dqdt = (adfaco * jac
            + (ah2[:, None, None] / cfg.fnot) * d4p
            - (ah4[:, None, None] / cfg.fnot) * d6full)
    if not cyclic:
        # box: advective+diffusive tendency is zero on W/E columns
        dqdt = jnp.where(_col_mask(po[0], 0) | _col_mask(po[0], -1),
                         0.0, dqdt)

    # Layer forcing: Ekman pumping, entrainment, bottom drag --
    # one-hot layer masks keep the whole update in one fused kernel
    # (vs. three full-array dynamic-update-slices).
    lhot = jnp.eye(nlo, dtype=po.dtype)[:, :, None, None]
    qdot = (dqdt
            + lhot[0] * (fohfac[0] * (forcing.wekpo - entoc))
            + lhot[1] * (fohfac[1] * entoc)
            - lhot[nlo - 1] * (bdrfac * del2p[-1][None]))

    # Leapfrog update of interior rows (boundaries via ocqbdy)
    qo_new = qom + tdto * qdot
    if cfg.sponge.enabled:
        betay = (cfg.beta * jnp.asarray(g.yporel, dtype=qo.dtype)
                 )[None, :, None]
        qo_new = qo_new + tdto * cfg.sponge.c1_spl * model.r_spl[None] \
            * (qom - betay)
    qo_new = jnp.where(zonal, qo, qo_new)
    qom_new = qo

    if not cyclic:
        return qo_new, qom_new, None

    # Cyclic: boundary contributions to the momentum constraints
    # (qgosubs.F:150-163 bottom drag; ocadif:279-297,404-443)
    pe, pw = _eshift(po), _wshift(po)
    pdx_s = (pe - pw)[:, 1, :]      # p_x*2dx along j=2 row (0-based 1)
    pdx_n = (pe - pw)[:, -2, :]
    wend = jnp.ones(po.shape[-1], dtype=po.dtype).at[0].set(0.5).at[-1].set(0.5)
    aj5s = jnp.sum(wend * qo[:, 0, :] * pdx_s, axis=-1)
    aj9s = jnp.sum(wend * qo[:, 1, :] * pdx_s, axis=-1)
    aj5n = -jnp.sum(wend * qo[:, -1, :] * pdx_n, axis=-1)
    aj9n = -jnp.sum(wend * qo[:, -2, :] * pdx_n, axis=-1)
    ajis = cfg.fnot * adfaco * (aj5s + 2.0 * aj9s) * g.dxo * g.dyo
    ajin = cfg.fnot * adfaco * (aj5n + 2.0 * aj9n) * g.dxo * g.dyo

    ap3s = ah2 * jnp.sum(del2p[:, 1, :-1] - del2p[:, 0, :-1], axis=-1)
    ap3n = ah2 * jnp.sum(del2p[:, -1, :-1] - del2p[:, -2, :-1], axis=-1)
    ap5s = ah4 * jnp.sum(d4p[:, 1, :-1] - d4p[:, 0, :-1], axis=-1)
    ap5n = ah4 * jnp.sum(d4p[:, -1, :-1] - d4p[:, -2, :-1], axis=-1)

    bdsums = jnp.sum(pom[-1, 1, :-1] - pom[-1, 0, :-1])
    bdsumn = jnp.sum(pom[-1, -1, :-1] - pom[-1, -2, :-1])
    half_ek = 0.5 * jnp.sign(cfg.fnot) * cfg.ocean.delek
    bdrins = half_ek * bdsums
    bdrinn = half_ek * bdsumn

    cyc = dict(ajis=ajis, ajin=ajin, ap3s=ap3s, ap3n=ap3n,
               ap5s=ap5s, ap5n=ap5n, bdrins=bdrins, bdrinn=bdrinn)
    return qo_new, qom_new, cyc


def _cyclic_boundary_terms(model, state, forcing, del2p_s, del2p_n,
                           d4p_s, d4p_n):
    """Momentum-constraint boundary integrals from 2-row wall slices of
    del2p / del4p plus the state rows (qgosubs.F:150-163, 279-297,
    404-443). Shapes: *_s/*_n are (nlo, 2, nxpo), row 0 nearest wall."""
    cfg = model.cfg
    g = model.grids
    po, pom, qo = state.po, state.pom, state.qo
    adfaco = 1.0 / (12.0 * g.dxo * g.dyo * cfg.fnot)
    ah2 = jnp.asarray(cfg.ocean.ah2oc, dtype=po.dtype)
    ah4 = jnp.asarray(cfg.ocean.ah4oc, dtype=po.dtype)

    pe, pw = _eshift(po), _wshift(po)
    pdx_s = (pe - pw)[:, 1, :]
    pdx_n = (pe - pw)[:, -2, :]
    wend = jnp.ones(po.shape[-1], dtype=po.dtype).at[0].set(0.5) \
        .at[-1].set(0.5)
    aj5s = jnp.sum(wend * qo[:, 0, :] * pdx_s, axis=-1)
    aj9s = jnp.sum(wend * qo[:, 1, :] * pdx_s, axis=-1)
    aj5n = -jnp.sum(wend * qo[:, -1, :] * pdx_n, axis=-1)
    aj9n = -jnp.sum(wend * qo[:, -2, :] * pdx_n, axis=-1)
    ajis = cfg.fnot * adfaco * (aj5s + 2.0 * aj9s) * g.dxo * g.dyo
    ajin = cfg.fnot * adfaco * (aj5n + 2.0 * aj9n) * g.dxo * g.dyo

    ap3s = ah2 * jnp.sum(del2p_s[:, 1, :-1] - del2p_s[:, 0, :-1], axis=-1)
    ap3n = ah2 * jnp.sum(del2p_n[:, 1, :-1] - del2p_n[:, 0, :-1], axis=-1)
    ap5s = ah4 * jnp.sum(d4p_s[:, 1, :-1] - d4p_s[:, 0, :-1], axis=-1)
    ap5n = ah4 * jnp.sum(d4p_n[:, 1, :-1] - d4p_n[:, 0, :-1], axis=-1)

    bdsums = jnp.sum(pom[-1, 1, :-1] - pom[-1, 0, :-1])
    bdsumn = jnp.sum(pom[-1, -1, :-1] - pom[-1, -2, :-1])
    half_ek = 0.5 * (1.0 if cfg.fnot > 0 else -1.0) * cfg.ocean.delek
    return dict(ajis=ajis, ajin=ajin, ap3s=ap3s, ap3n=ap3n,
                ap5s=ap5s, ap5n=ap5n, bdrins=half_ek * bdsums,
                bdrinn=half_ek * bdsumn)


def _edge_d2d4(pom, bcfac, dxm2):
    """Thin-slice recomputation of the 2 wall-adjacent rows of del2p
    and del4p (cyclic case) for the constraint integrals, avoiding a
    second full-field dissipation pass in the shard_map halo path.
    Returns (d2_s, d2_n, d4_s, d4_n), each (nl, 2, nxpo) with row
    order [wall, wall+1] (south) / [wall-1, wall] reversed so index 0
    is nearest the wall... south rows are [0, 1]; north rows [-2, -1]
    mapped to ([wall, inner]) consistently with the caller."""

    def lap_row(r3):
        w, e = _wshift(r3[:, 1]), _eshift(r3[:, 1])
        return dxm2 * (r3[:, 0] + r3[:, 2] + w + e - 4.0 * r3[:, 1])

    d2s = del2_bc(pom[:, :5], bcfac, dxm2, True)[:, :3]
    d2n = del2_bc(pom[:, -5:], bcfac, dxm2, True)[:, -3:]
    d4s0 = bcfac * (d2s[:, 1] - d2s[:, 0])
    d4s1 = lap_row(d2s[:, 0:3])
    d4n1 = lap_row(d2n[:, -3:])
    d4n0 = bcfac * (d2n[:, -2] - d2n[:, -1])
    d4_s = jnp.stack([d4s0, d4s1], axis=1)
    d4_n = jnp.stack([d4n1, d4n0], axis=1)
    return d2s[:, :2], d2n[:, -2:], d4_s, d4_n


def _qgstep_consts(model):
    """The python-float constants tuple of the shard_map-halo
    vorticity step (parallel/halo.qgstep_halo)."""
    cfg = model.cfg
    g = model.grids
    dxom2 = 1.0 / g.dxo**2
    return (dxom2, cfg.ocean.bccooc * dxom2 / (0.5 * cfg.ocean.bccooc + 1.0),
            1.0 / (12.0 * g.dxo * g.dyo * cfg.fnot), 1.0 / cfg.fnot,
            2.0 * cfg.dto,
            0.5 * (1.0 if cfg.fnot > 0 else -1.0) * cfg.ocean.delek
            / cfg.ocean.hoc[-1],
            cfg.sponge.c1_spl, cfg.beta * float(g.yporel[0]),
            cfg.beta * g.dyo,
            cfg.fnot / cfg.ocean.hoc[0], cfg.fnot / cfg.ocean.hoc[1])


def _qgostep_halo(model, state, forcing, entoc, mesh, variant):
    """shard_map halo-exchange variant of _qgostep
    (parallel/halo.qgstep_halo): explicit ppermute halos over the mesh
    'y' axis, bit-identical update. Cyclic constraint integrals are
    recomputed from thin wall slices (_edge_d2d4)."""
    from ..parallel.halo import qgstep_halo
    cfg = model.cfg
    cyclic = cfg.cyclic_ocean
    sponge = cfg.sponge.enabled
    rspl = (model.r_spl if sponge else jnp.zeros_like(forcing.wekpo))
    qo_new = qgstep_halo(
        state.pom, state.po, state.qo, state.qom, forcing.wekpo, entoc,
        rspl, _qgstep_consts(model), cfg.ocean.ah2oc, cfg.ocean.ah4oc,
        cyclic=cyclic, sponge=sponge, mesh=mesh, variant=variant)
    qom_new = state.qo
    if not cyclic:
        return qo_new, qom_new, None
    dxom2 = 1.0 / model.grids.dxo**2
    bcfaco = cfg.ocean.bccooc * dxom2 / (0.5 * cfg.ocean.bccooc + 1.0)
    d2s, d2n, d4s, d4n = _edge_d2d4(state.pom, bcfaco, dxom2)
    cyc = _cyclic_boundary_terms(model, state, forcing, d2s, d2n,
                                 d4s, d4n)
    return qo_new, qom_new, cyc


# ----------------------------------------------------------------------
# PV inversion (src/ocisubs.F ocinvq)
# ----------------------------------------------------------------------

def _ocinvq(model: Model, state: OceanState, qo_new: jnp.ndarray,
            xon1, enis1, enin1, cyc, forcing: OceanForcing):
    """Invert PV to pressure; apply mass/momentum constraints.
    Returns (po_new, pom_new, constraint-state updates, diags)."""
    cfg = model.cfg
    g = model.grids
    inv = model.inv_oc
    nlo = cfg.nlo
    dtype = state.po.dtype
    tdto = 2.0 * cfg.dto
    cl2m = jnp.asarray(model.modes_oc.cl2m, dtype=dtype)   # (m, k)
    cm2l = jnp.asarray(model.modes_oc.cm2l, dtype=dtype)   # (k, m)
    gpoc = jnp.asarray(cfg.ocean.gpoc, dtype=dtype)
    hoc = jnp.asarray(cfg.ocean.hoc, dtype=dtype)
    ddyn = model.topo.ddynoc_or_scalar(dtype)
    betay = (cfg.beta * jnp.asarray(g.yporel, dtype=dtype))[None, :, None]

    # Modal vorticity RHS (8.13): wrk_m = f0 * sum_k cl2m[m,k] (q_k - by)
    kb = jnp.eye(nlo, dtype=dtype)[nlo - 1][:, None, None]
    ql = qo_new - betay - kb * ddyn
    wrk = cfg.fnot * jnp.einsum("mk,kyx->myx", cl2m, ql,
                                precision="highest")

    ecrito = 1.0e-13

    if cfg.cyclic_ocean:
        # Solve the modified Helmholtz problem for each mode (batched)
        sol = inv.helm.solve(wrk)
        xinhom = xintp(sol) * g.dxo * g.dyo     # (nlo,)
        # --- momentum + mass constraints (ocisubs.F:169-327) ---
        entfac = 0.5 * g.dyo * cfg.fnot**2
        enis = jnp.zeros(nlo - 1, dtype=dtype).at[0].set(enis1)
        enin = jnp.zeros(nlo - 1, dtype=dtype).at[0].set(enin1)
        # per-layer entrainment difference e(k) - e(k-1) with e(0)=wek
        # handled via explicit assembly as in ocisubs.F:176-193
        ent_s = jnp.concatenate([enis, jnp.zeros((1,), dtype)])
        ent_sm = jnp.concatenate([jnp.zeros((1,), dtype), enis])
        ent_n = jnp.concatenate([enin, jnp.zeros((1,), dtype)])
        ent_nm = jnp.concatenate([jnp.zeros((1,), dtype), enin])
        rhss = (entfac / hoc) * (ent_s - ent_sm) + cyc["ajis"] \
            - cyc["ap3s"] + cyc["ap5s"]
        rhsn = (entfac / hoc) * (ent_n - ent_nm) + cyc["ajin"] \
            + cyc["ap3n"] - cyc["ap5n"]
        rhss = rhss.at[0].add((cfg.fnot / hoc[0]) * forcing.txisoc)
        rhsn = rhsn.at[0].add(-(cfg.fnot / hoc[0]) * forcing.txinoc)
        rhss = rhss.at[-1].add((cfg.fnot / hoc[-1]) * cyc["bdrins"])
        rhsn = rhsn.at[-1].add(-(cfg.fnot / hoc[-1]) * cyc["bdrinn"])

        # Leapfrog the constraint vectors (ocisubs.F:197-206)
        ocsnew = state.ocncsp + tdto * rhss
        ocnnew = state.ocncnp + tdto * rhsn
        ocncsp_new, ocncnp_new = state.ocncs, state.ocncn
        ocncs_new, ocncn_new = ocsnew, ocnnew

        # Line integrals of dp/dy of the inhomogeneous solutions
        ayis = _line_sum_p(sol[:, 1, :]) * (g.dxo / g.dyo)
        ayin = -_line_sum_p(sol[:, -2, :]) * (g.dxo / g.dyo)
        clhss = jnp.matmul(cl2m, ocsnew, precision="highest") + ayis
        clhsn = jnp.matmul(cl2m, ocnnew, precision="highest") - ayin

        # Homogeneous solution coefficients (ocisubs.F:238-246)
        c3 = clhss[0] * inv.hbsioc
        c1 = inv.hc2n * clhss[1:] - inv.hc2s * clhsn[1:]
        c2 = inv.hc1s * clhsn[1:] - inv.hc1n * clhss[1:]

        # Area integrals of modal & layer pressures
        aipmod = xinhom.at[0].add(c3 * inv.aipbho)
        aipmod = aipmod.at[1:].add((c1 + c2) * inv.aipcho)
        aiplay = jnp.matmul(cm2l, aipmod, precision="highest")

        # Continuity monitoring + update (ocisubs.F:266-294);
        # entrainment acts across interface 1 only (xon(k>1) = 0)
        aient = jnp.zeros(nlo - 1, dtype=dtype).at[0].set(xon1)
        est1 = aiplay[1:] - aiplay[:-1]
        est2 = state.dpiocp - tdto * gpoc * aient
        edif = est1 - est2
        esum = jnp.abs(est1) + jnp.abs(est2)
        ermaso = edif
        thresh = ecrito * g.xlo * g.ylo * tdto * gpoc
        emfroc = jnp.where(esum > thresh, 2.0 * edif / esum, 0.0)
        dpiocp_new = state.dpioc
        dpioc_new = est1

        homcor = jnp.concatenate([
            (c3 * inv.pbhoc)[None, :],
            c1[:, None] * inv.pch1oc + c2[:, None] * inv.pch2oc,
        ], axis=0)                                     # (nlo, nypo)
        pm = sol + homcor[:, :, None]
        po_new = jnp.einsum("km,myx->kyx", cm2l, pm, precision="highest")
        return (po_new, state.po, dpioc_new, dpiocp_new,
                ocncs_new, ocncn_new, ocncsp_new, ocncnp_new,
                ermaso, emfroc)

    # --- box: mass constraint only (ocisubs.F:328-401) ---
    # Everything stays in spectral space until one inverse transform:
    # the inhomogeneous-solution area integrals come from a Parseval
    # contraction with the DST of the ones vector (sol vanishes on the
    # boundary, so the trapezoid weights reduce to interior ones), and
    # the homogeneous correction hclco*ochom, ochom = 1 + rdm2*sol0
    # with Helm(sol0) = 1, is added as a separable spectrum -- the
    # reference's precomputed ochom FIELD (conhoms.F:544-641) would be
    # a grid-sized constant baked into the compiled program.
    helm = inv.helm
    blocks = getattr(helm, "supports_blocks", False)
    if blocks:
        # Tree-form spectra: the packed split levels stay separate
        # arrays through the whole spectral phase, skipping the
        # misaligned inter-level concatenations of the forward
        # transform and the inverse's input slicing.  The constraint
        # algebra runs per (x-block, y-block); the segment layout
        # lives in the solver (helm.block_algebra).
        spec = helm.forward_blocks(wrk)
        denoms, gxs, gys = helm.block_algebra()
        xin = 0.0
        for i in range(len(gxs)):
            for j in range(len(gys)):
                xin = xin + jnp.einsum(
                    "myx,y,x->m", spec[i][j] / denoms[i][j],
                    gys[j], gxs[i], precision="highest")
        xinhom = helm.norm * xin * g.dxo * g.dyo
    else:
        fwd = helm.forward(wrk)
        denom = helm._denom()
        # fwd/denom is NOT materialised: the divide fuses into this
        # reduction, and the corrected spectrum below is built from
        # fwd in one pass.
        xinhom = helm.norm * jnp.einsum(
            "myx,y,x->m", fwd / denom, helm.gy, helm.gx,
            precision="highest") * g.dxo * g.dyo

    aient = jnp.zeros(nlo - 1, dtype=dtype).at[0].set(xon1)
    dpioc_new = state.dpiocp - tdto * gpoc * aient
    dpiocp_new = state.dpioc
    rhsum = jnp.einsum("mk,m->k", inv.cdiffo, xinhom, precision="highest")
    rhs = dpioc_new - rhsum
    hclco = jnp.matmul(inv.cdhinv, rhs, precision="highest")

    zero1 = jnp.zeros((1,), dtype)
    coef = jnp.concatenate([zero1, hclco * helm.rdm2[1:]])
    if blocks:
        corr = [[(spec[i][j] + coef[:, None, None]
                  * (gys[j][None, :, None] * gxs[i][None, None, :]))
                 / denoms[i][j]
                 for j in range(len(gys))]
                for i in range(len(gxs))]
        pm = helm.inverse_blocks(corr) \
            + jnp.concatenate([zero1, hclco])[:, None, None]
    else:
        # jnp.asarray before the outer product: helm.gy/gx are host
        # NumPy and would otherwise broadcast eagerly into a
        # grid-sized constant
        gyx = (jnp.asarray(helm.gy)[None, :, None]
               * jnp.asarray(helm.gx)[None, None, :])
        spec = (fwd + coef[:, None, None] * gyx) / denom
        pm = helm.inverse(spec) \
            + jnp.concatenate([zero1, hclco])[:, None, None]
    po_new = jnp.einsum("km,myx->kyx", cm2l, pm, precision="highest")
    zero = jnp.zeros(nlo - 1, dtype=dtype)
    return (po_new, state.po, dpioc_new, dpiocp_new,
            state.ocncs, state.ocncn, state.ocncsp, state.ocncnp,
            zero, zero)


# ----------------------------------------------------------------------
# Full substep + init helpers
# ----------------------------------------------------------------------

def make_ocean_step(model: Model, halo=None):
    """Build the fused ocean substep:
    oml -> qgostep -> ocinvq -> ocqbdy (main loop q-gcm.F:1222-1255).

    halo: optional (mesh, variant) pair routing the vorticity step
    through the explicit shard_map halo-exchange path
    (parallel/halo.py) instead of GSPMD; variant is 'staged', 'deep'
    or 'overlap'."""
    cfg = model.cfg
    g = model.grids
    dtype = jnp.dtype(cfg.dtype)
    dxom2 = 1.0 / g.dxo**2
    amat = np.asarray(model.modes_oc.amat, dtype=dtype)
    yporel = np.asarray(g.yporel, dtype=dtype)
    ddyn = model.topo.ddynoc_or_scalar(dtype)

    def step(state: OceanState, forcing: OceanForcing):
        if cfg.no_oml:
            zero = jnp.zeros((), dtype=state.po.dtype)
            entoc = jnp.zeros_like(state.po[0])
            sst_new, sstm_new = state.sst, state.sstm
            xon1 = enis1 = enin1 = cfraoc = centoc = zero
        else:
            (sst_new, sstm_new, entoc, xon1, enis1, enin1,
             cfraoc, centoc) = _oml(model, state, forcing)

        if halo is not None:
            qo_new, qom_new, cyc = _qgostep_halo(
                model, state, forcing, entoc, halo[0], halo[1])
        else:
            qo_new, qom_new, cyc = _qgostep(model, state, forcing,
                                            entoc)

        (po_new, pom_new, dpioc, dpiocp, ocncs, ocncn, ocncsp, ocncnp,
         ermaso, emfroc) = _ocinvq(model, state, qo_new, xon1,
                                   enis1, enin1, cyc, forcing)

        qo_new = ocqbdy(qo_new, po_new, amat, yporel, dxom2, cfg.fnot,
                        cfg.beta, cfg.ocean.bccooc, ddyn,
                        cfg.cyclic_ocean)

        new_state = OceanState(
            po=po_new, pom=pom_new, qo=qo_new, qom=qom_new,
            sst=sst_new, sstm=sstm_new,
            dpioc=dpioc, dpiocp=dpiocp,
            ocncs=ocncs, ocncn=ocncn, ocncsp=ocncsp, ocncnp=ocncnp)
        diags = OceanStepDiags(ermaso=ermaso, emfroc=emfroc, xon1=xon1,
                               cfraoc=cfraoc, centoc=centoc)
        return new_state, diags

    return step


def init_ocean_state(model: Model, init: str = "zero",
                     po=None, pom=None, sst=None, sstm=None) -> OceanState:
    """Initial ocean state: 'zero' (q-gcm.F zeroin:1615), 'rbal'
    (rbalin:1712 -- zero pressure, sstbar SST), or explicit arrays.
    PV is derived from pressure (q-gcm.F:715-732), and the constraint
    variables from `constr` (src/conhoms.F:44-199)."""
    cfg = model.cfg
    dtype = jnp.dtype(cfg.dtype)
    nlo, nypo, nxpo = cfg.nlo, cfg.nypo, cfg.nxpo
    nyto, nxto = cfg.nyto, cfg.nxto

    if po is None:
        po = jnp.zeros((nlo, nypo, nxpo), dtype=dtype)
    else:
        po = jnp.asarray(po, dtype=dtype)
    pom = po if pom is None else jnp.asarray(pom, dtype=dtype)
    if sst is None:
        if init == "rbal":
            sst = jnp.broadcast_to(
                jnp.asarray(model.rad.sstbar, dtype=dtype)[:, None],
                (nyto, nxto))
        else:
            sst = jnp.zeros((nyto, nxto), dtype=dtype)
    else:
        sst = jnp.asarray(sst, dtype=dtype)
    sstm = sst if sstm is None else jnp.asarray(sstm, dtype=dtype)

    amat = jnp.asarray(model.modes_oc.amat, dtype=dtype)
    yporel = jnp.asarray(model.grids.yporel, dtype=dtype)
    ddyn = model.topo.ddynoc_or_scalar(dtype)
    dxom2 = 1.0 / model.grids.dxo**2

    def q_from_p(p):
        q = qcomp(p, amat, yporel, dxom2, cfg.fnot, cfg.beta, ddyn,
                  nlo - 1, cfg.cyclic_ocean)
        return ocqbdy(q, p, amat, yporel, dxom2, cfg.fnot, cfg.beta,
                      cfg.ocean.bccooc, ddyn, cfg.cyclic_ocean)

    qo = q_from_p(po)
    qom = q_from_p(pom)

    # constr (conhoms.F:93-199): mass + momentum constraint values
    g = model.grids
    area = g.dxo * g.dyo
    dpioc = xintp(po[1:] - po[:-1]) * area
    dpiocp = xintp(pom[1:] - pom[:-1]) * area

    if cfg.cyclic_ocean:
        amat_j = jnp.asarray(model.modes_oc.amat, dtype=dtype)
        fsq = 0.5 * g.dyo * cfg.fnot**2

        def momcon(p):
            pins = g.dxo * _line_sum_p(p[:, 0, :])
            pinn = g.dxo * _line_sum_p(p[:, -1, :])
            cs = _line_sum_p(p[:, 1, :] - p[:, 0, :]) * (g.dxo / g.dyo)
            cn = _line_sum_p(p[:, -1, :] - p[:, -2, :]) * (g.dxo / g.dyo)
            cs = -cs + fsq * jnp.matmul(amat_j, pins,
                                        precision="highest")
            cn = cn + fsq * jnp.matmul(amat_j, pinn,
                                        precision="highest")
            return cs, cn

        ocncs, ocncn = momcon(po)
        ocncsp, ocncnp = momcon(pom)
    else:
        z = jnp.zeros(nlo, dtype=dtype)
        ocncs = ocncn = ocncsp = ocncnp = z

    return OceanState(po=po, pom=pom, qo=qo, qom=qom, sst=sst, sstm=sstm,
                      dpioc=dpioc, dpiocp=dpiocp,
                      ocncs=ocncs, ocncn=ocncn,
                      ocncsp=ocncsp, ocncnp=ocncnp)


def ocean_forcing_from_mean(model: Model, tauxo, tauyo,
                            fnetoc) -> OceanForcing:
    """Build the static OceanForcing for ocean_only runs from mean
    windstress + heat flux (read from avges.nc or generated). Derives
    the Ekman velocities and boundary stress integrals exactly as the
    ocean section of xforc does (src/xfosubs.F:568-707)."""
    cfg = model.cfg
    g = model.grids
    dtype = jnp.dtype(cfg.dtype)
    tauxo = jnp.asarray(tauxo, dtype=dtype)
    tauyo = jnp.asarray(tauyo, dtype=dtype)
    fnetoc = jnp.asarray(fnetoc, dtype=dtype)
    hxofac = 0.5 / (g.dxo * cfg.fnot)

    # Ekman velocity at T points (7.7): curl of tau around the T cell
    wekto = hxofac * (
        tauyo[:-1, 1:] + tauyo[1:, 1:] - tauyo[:-1, :-1] - tauyo[1:, :-1]
        + tauxo[:-1, :-1] + tauxo[:-1, 1:] - tauxo[1:, :-1] - tauxo[1:, 1:])

    # wekpo by averaging wekto (xfosubs.F:589-646) -- same shape rules
    # as the entrainment averaging
    wekpo = _entrain_to_p(wekto, cfg.cyclic_ocean)

    if cfg.cyclic_ocean:
        txis = 0.5 * g.dxo * _line_sum_p(tauxo[0, :] + tauxo[1, :])
        txin = 0.5 * g.dxo * _line_sum_p(tauxo[-2, :] + tauxo[-1, :])
    else:
        txis = jnp.zeros((), dtype=dtype)
        txin = jnp.zeros((), dtype=dtype)

    return OceanForcing(tauxo=tauxo, tauyo=tauyo, fnetoc=fnetoc,
                        wekto=wekto, wekpo=wekpo,
                        txisoc=txis, txinoc=txin)
