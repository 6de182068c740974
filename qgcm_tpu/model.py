"""Model assembly: one-time host-side initialisation.

Gathers everything the jitted step functions need: grids, vertical
modes, radiation coefficients, topography, Helmholtz solvers,
homogeneous solutions and constraint matrices. Mirrors the init phase
of the reference main program (src/q-gcm.F:194-991 and
src/conhoms.F homsol/constr), re-expressed as pure functions.

All heavy per-step state lives in `state.OceanState`/`AtmosState`;
everything here is O(grid) static data baked into the jitted step.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import jax.numpy as jnp
import numpy as np

from .config import ModelConfig
from .grids import Grids, build_grids
from .modes import Modes, eigenmodes
from .radiation import Radiation, radiat
from .topo import Topography, build_topography, TopoSpec
from .coupling import Coupling, build_coupling
from .ops.integrals import xintp_weights
from .solver.helmholtz import (
    DST_BACKENDS, BoxHelmholtz, CyclicHelmholtz, make_box_helmholtz,
    make_cyclic_helmholtz,
)


@dataclass(frozen=True)
class OceanInversion:
    """Static data for the oceanic PV inversion (ocinvq)."""
    helm: object                     # Box/CyclicHelmholtz over nlo modes
    # box case (conhoms.F:544-641); the homogeneous-solution FIELD is
    # never stored -- the step applies it spectrally (models/ocean.py)
    cdiffo: Optional[jnp.ndarray]    # (nlo, nlo-1)
    cdhinv: Optional[jnp.ndarray]    # (nlo-1, nlo-1) inverse of cdhoc
    # cyclic case (conhoms.F:376-543)
    pbhoc: Optional[jnp.ndarray]     # (nypo,) barotropic homog. profile
    pch1oc: Optional[jnp.ndarray]    # (nlo-1, nypo)
    pch2oc: Optional[jnp.ndarray]    # (nlo-1, nypo)
    hbsioc: Optional[float]
    aipbho: Optional[float]
    aipcho: Optional[jnp.ndarray]    # (nlo-1,)
    hc1s: Optional[jnp.ndarray]      # (nlo-1,)
    hc2s: Optional[jnp.ndarray]
    hc1n: Optional[jnp.ndarray]
    hc2n: Optional[jnp.ndarray]


@dataclass(frozen=True)
class AtmosInversion:
    """Static data for the atmospheric PV inversion (atinvq); the
    atmosphere is always a cyclic channel."""
    helm: CyclicHelmholtz
    pbhat: jnp.ndarray               # (nypa,)
    pch1at: jnp.ndarray              # (nla-1, nypa)
    pch2at: jnp.ndarray
    hbsiat: float
    aipbha: float
    aipcha: jnp.ndarray
    hc1s: jnp.ndarray
    hc2s: jnp.ndarray
    hc1n: jnp.ndarray
    hc2n: jnp.ndarray


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    grids: Grids
    modes_oc: Modes
    modes_at: Modes
    rad: Radiation
    topo: Topography
    inv_oc: Optional[OceanInversion]
    inv_at: Optional[AtmosInversion]
    coupling: Optional[Coupling]
    wop: jnp.ndarray                 # (nypo, nxpo) p-grid integral weights
    wap: jnp.ndarray                 # (nypa, nxpa)
    r_spl: Optional[jnp.ndarray]     # (nypo, nxpo) k247 sponge ramp


def _sponge_ramp(cfg: ModelConfig) -> np.ndarray:
    """k247 sponge ramp (reference src/q-gcm.F:1152-1181): Gaussian-like
    ramps rising towards the N/S (and optionally W/E) boundaries.
    NOTE: the reference uses 1-based indices i,j directly in the
    distance formula; we reproduce that exactly."""
    dxo = cfg.ocean.dxo
    dyo = dxo
    l_spl = cfg.sponge.l_spl
    i = np.arange(1, cfg.nxpo + 1, dtype=np.float64)
    j = np.arange(1, cfg.nypo + 1, dtype=np.float64)
    dy = (0.5 * dyo * cfg.nypo - np.abs(dyo * j - 0.5 * dyo * cfg.nypo))
    ry = np.exp(-2.0 * np.pi * (dy / l_spl) ** 2)
    r = np.broadcast_to(ry[:, None], (cfg.nypo, cfg.nxpo)).copy()
    if not cfg.sponge.nospl_in_ewbdy:
        dx = (0.5 * dxo * cfg.nxpo - np.abs(dxo * i - 0.5 * dxo * cfg.nxpo))
        rx = np.exp(-2.0 * np.pi * (dx / l_spl) ** 2)
        r = r + rx[None, :]
    return r


def _channel_homogeneous(helm, nyp: int, nxp: int, yp: np.ndarray,
                         rdm2: np.ndarray, dx: float, dy: float,
                         wp: np.ndarray, norm_cells: float, cyclic_dup: bool):
    """Homogeneous solutions for a zonally-cyclic channel
    (conhoms.F:376-543 ocean / :644-811 atmosphere).

    Returns (pbh, pch1, pch2, hbsi, aipbh, aipch, hc1s, hc2s, hc1n, hc2n).
    """
    nl = len(rdm2)
    yl = yp[-1] - yp[0]
    xl = (nxp - 1) * dx
    jj = np.arange(1, nyp + 1, dtype=np.float64)
    pbh = (nyp - jj) / (nyp - 1)
    hbsi = yl / xl
    aipbh = 0.5 * xl * yl

    # Baroclinic: pch = L(y) + rdm2*sol0 with Helmholtz{sol0} = L(y)
    L1 = (yp[-1] - yp) / yl                      # 1 at S, 0 at N
    L2 = (yp - yp[0]) / yl                       # 0 at S, 1 at N
    rhs = np.zeros((2 * (nl - 1), nyp, nxp))
    for m in range(nl - 1):
        rhs[2 * m] = L1[:, None]
        rhs[2 * m + 1] = L2[:, None]
    # Build a solver over the baroclinic modes (each repeated twice)
    rd = np.repeat(rdm2[1:], 2)
    sub = make_cyclic_helmholtz(nxp, nyp, dx, dy, rd, dtype=jnp.float64)
    sol = sub.solve_np(rhs)

    pch1 = np.empty((nl - 1, nyp))
    pch2 = np.empty((nl - 1, nyp))
    aipch = np.empty(nl - 1)
    hc1s = np.empty(nl - 1)
    hc2s = np.empty(nl - 1)
    hc1n = np.empty(nl - 1)
    hc2n = np.empty(nl - 1)
    for m in range(nl - 1):
        f1 = L1[:, None] + rdm2[m + 1] * sol[2 * m]
        f2 = L2[:, None] + rdm2[m + 1] * sol[2 * m + 1]
        pch1[m] = f1[:, 0]
        pch2[m] = f2[:, 0]
        ai1 = (f1 * wp).sum() * dx * dy
        ai2 = (f2 * wp).sum() * dx * dy
        aipch[m] = 0.5 * (ai1 + ai2)
        # dp/dy half a gridpoint in from the boundaries, corrected and
        # converted to line integrals (conhoms.F:514-534)
        p1ys = -(pch1[m][1] - pch1[m][0]) / dy \
            + 0.5 * dy * rdm2[m + 1] * pch1[m][0]
        p2ys = -(pch2[m][1] - pch2[m][0]) / dy \
            + 0.5 * dy * rdm2[m + 1] * pch2[m][0]
        p1yn = (pch1[m][-1] - pch1[m][-2]) / dy \
            + 0.5 * dy * rdm2[m + 1] * pch1[m][-1]
        p2yn = (pch2[m][-1] - pch2[m][-2]) / dy \
            + 0.5 * dy * rdm2[m + 1] * pch2[m][-1]
        p1ys, p2ys, p1yn, p2yn = (xl * v for v in (p1ys, p2ys, p1yn, p2yn))
        det = p1ys * p2yn - p2ys * p1yn
        hc1s[m] = p1ys / det
        hc2s[m] = p2ys / det
        hc1n[m] = p1yn / det
        hc2n[m] = p2yn / det
    return pbh, pch1, pch2, hbsi, aipbh, aipch, hc1s, hc2s, hc1n, hc2n


def _build_ocean_inversion(cfg: ModelConfig, grids: Grids,
                           modes: Modes, wop: np.ndarray,
                           dtype, dst: str = "fft") -> OceanInversion:
    nxpo, nypo = cfg.nxpo, cfg.nypo
    dxo, dyo = grids.dxo, grids.dyo
    nlo = cfg.nlo

    if cfg.cyclic_ocean:
        helm = make_cyclic_helmholtz(nxpo, nypo, dxo, dyo, modes.rdm2,
                                     dtype=dtype, ytransform=dst)
        (pbh, pch1, pch2, hbsi, aipbh, aipch,
         hc1s, hc2s, hc1n, hc2n) = _channel_homogeneous(
            helm, nypo, nxpo, grids.ypo, modes.rdm2, dxo, dyo, wop,
            cfg.ocnorm, True)
        return OceanInversion(
            helm=helm, cdiffo=None, cdhinv=None,
            pbhoc=np.asarray(pbh, dtype=dtype),
            pch1oc=np.asarray(pch1, dtype=dtype),
            pch2oc=np.asarray(pch2, dtype=dtype),
            hbsioc=float(hbsi), aipbho=float(aipbh),
            aipcho=np.asarray(aipch, dtype=dtype),
            hc1s=np.asarray(hc1s, dtype=dtype),
            hc2s=np.asarray(hc2s, dtype=dtype),
            hc1n=np.asarray(hc1n, dtype=dtype),
            hc2n=np.asarray(hc2n, dtype=dtype),
        )

    # Finite box (conhoms.F:544-641)
    helm = make_box_helmholtz(nxpo, nypo, dxo, dyo, modes.rdm2,
                              dtype=dtype, transform=dst)
    sub = make_box_helmholtz(nxpo, nypo, dxo, dyo, modes.rdm2[1:],
                             dtype=jnp.float64)
    ones = np.ones((nlo - 1, nypo, nxpo))
    sol0 = sub.solve_np(ones)
    ochom = 1.0 + modes.rdm2[1:, None, None] * sol0
    aipohs = (ochom * wop[None]).sum(axis=(1, 2)) * dxo * dyo

    cm2l = modes.cm2l                              # (k, m)
    cdiffo = cm2l[1:, :] - cm2l[:-1, :]            # (nlo-1 interfaces, nlo modes) -> transpose
    cdiffo = cdiffo.T                              # (m, k): cdiffo[m,k]
    cdhoc = np.empty((nlo - 1, nlo - 1))
    for k in range(nlo - 1):
        for m in range(nlo - 1):
            cdhoc[k, m] = (cm2l[k + 1, m + 1] - cm2l[k, m + 1]) * aipohs[m]
    cdhinv = np.linalg.inv(cdhoc)
    return OceanInversion(
        helm=helm,
        cdiffo=np.asarray(cdiffo, dtype=dtype),
        cdhinv=np.asarray(cdhinv, dtype=dtype),
        pbhoc=None, pch1oc=None, pch2oc=None, hbsioc=None,
        aipbho=None, aipcho=None, hc1s=None, hc2s=None, hc1n=None,
        hc2n=None,
    )


def _build_atmos_inversion(cfg: ModelConfig, grids: Grids,
                           modes: Modes, wap: np.ndarray,
                           dtype, dst: str = "fft") -> AtmosInversion:
    nxpa, nypa = cfg.nxpa, cfg.nypa
    dxa, dya = grids.dxa, grids.dya
    helm = make_cyclic_helmholtz(nxpa, nypa, dxa, dya, modes.rdm2,
                                 dtype=dtype, ytransform=dst)
    (pbh, pch1, pch2, hbsi, aipbh, aipch,
     hc1s, hc2s, hc1n, hc2n) = _channel_homogeneous(
        helm, nypa, nxpa, grids.ypa, modes.rdm2, dxa, dya, wap,
        cfg.atnorm, True)
    return AtmosInversion(
        helm=helm,
        pbhat=np.asarray(pbh, dtype=dtype),
        pch1at=np.asarray(pch1, dtype=dtype),
        pch2at=np.asarray(pch2, dtype=dtype),
        hbsiat=float(hbsi), aipbha=float(aipbh),
        aipcha=np.asarray(aipch, dtype=dtype),
        hc1s=np.asarray(hc1s, dtype=dtype),
        hc2s=np.asarray(hc2s, dtype=dtype),
        hc1n=np.asarray(hc1n, dtype=dtype),
        hc2n=np.asarray(hc2n, dtype=dtype),
    )


def build_model(cfg: ModelConfig,
                topocname: TopoSpec = "flat",
                topatname: TopoSpec = "flat",
                extant_oc=None, extant_at=None,
                atmver: bool = True) -> Model:
    cfg = cfg.validate()
    dtype = jnp.dtype(cfg.dtype)
    grids = build_grids(cfg)
    modes_oc = eigenmodes(cfg.ocean.gpoc, cfg.ocean.hoc, cfg.fnot)
    modes_at = eigenmodes(cfg.atmos.gpat, cfg.atmos.hat, cfg.fnot)
    rad = radiat(cfg, grids)
    topo = build_topography(cfg, grids, topocname, topatname,
                            extant_oc=extant_oc, extant_at=extant_at,
                            atmver=atmver)

    wop = xintp_weights(cfg.nypo, cfg.nxpo)
    wap = xintp_weights(cfg.nypa, cfg.nxpa)

    inv_oc = None if cfg.atmos_only else _build_ocean_inversion(
        cfg, grids, modes_oc, wop, dtype)
    inv_at = None if cfg.ocean_only else _build_atmos_inversion(
        cfg, grids, modes_at, wap, dtype)

    r_spl = (np.asarray(_sponge_ramp(cfg), dtype=dtype)
             if cfg.sponge.enabled else None)

    coupling = (build_coupling(cfg, grids, rad)
                if (not cfg.ocean_only or cfg.tau_udiff) else None)

    return Model(
        cfg=cfg, grids=grids, modes_oc=modes_oc, modes_at=modes_at,
        rad=rad, topo=topo, inv_oc=inv_oc, inv_at=inv_at,
        coupling=coupling,
        wop=np.asarray(wop, dtype=dtype),
        wap=np.asarray(wap, dtype=dtype),
        r_spl=r_spl,
    )


def with_dst(model: Model, dst: str) -> Model:
    """`model` with every PV-inversion solver on the DST backend `dst`
    (solver/helmholtz.DST_BACKENDS; build_model gives 'fft')."""
    if dst not in DST_BACKENDS:
        raise ValueError(f"dst must be one of {DST_BACKENDS}, got {dst!r}")
    invs = [i.helm for i in (model.inv_oc, model.inv_at) if i is not None]
    if all((h.transform if isinstance(h, BoxHelmholtz) else h.ytransform)
           == dst for h in invs):
        return model
    cfg = model.cfg
    dtype = jnp.dtype(cfg.dtype)
    inv_oc = None if model.inv_oc is None else _build_ocean_inversion(
        cfg, model.grids, model.modes_oc,
        xintp_weights(cfg.nypo, cfg.nxpo), dtype, dst)
    inv_at = None if model.inv_at is None else _build_atmos_inversion(
        cfg, model.grids, model.modes_at,
        xintp_weights(cfg.nypa, cfg.nxpa), dtype, dst)
    return replace(model, inv_oc=inv_oc, inv_at=inv_at)
