"""Running time means -> avges.nc (reference src/timavge.F).

The reference accumulates sums every step inside the main loop
(tavatm/tavocn, q-gcm.F:1477-1482) and writes means at interval end
(tavout -> avges.nc, variable list timavge.F:911-1256). Here the
accumulator is a pytree carried through the `lax.scan` time
loop, updated on-device each (sub)step; the host divides by the count
and writes at interval boundaries.

Eddy heat fluxes follow the reference's C-grid face-point semantics
(tavocn timavge.F:486-556, tavatm :340-400): velocity u is accumulated
at T-cell W/E faces (p-grid columns x T rows) and v at S/N faces
(T columns x p rows), along with T interpolated to the same faces and
the product u*T; the output uptp = <uT> - <u><T> (tavout
timavge.F:780-796, 850-870) lives on those face grids, boundary
conditions (box no-normal-flux, cyclic wrap, sb/nb_hflux outflow)
matching omladf/amladf.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np


class OceanAverages(NamedTuple):
    n: jnp.ndarray
    sst: jnp.ndarray
    wekto: jnp.ndarray
    fnetoc: jnp.ndarray
    tauxo: jnp.ndarray
    tauyo: jnp.ndarray
    wekpo: jnp.ndarray
    po: jnp.ndarray
    qo: jnp.ndarray
    uufo: jnp.ndarray     # (nyto, nxpo) u at T-cell W/E faces
    tufo: jnp.ndarray     # (nyto, nxpo) sst at W/E faces
    utufo: jnp.ndarray    # (nyto, nxpo) u*T product
    vvfo: jnp.ndarray     # (nypo, nxto) v at T-cell S/N faces
    tvfo: jnp.ndarray     # (nypo, nxto) sst at S/N faces
    vtvfo: jnp.ndarray    # (nypo, nxto) v*T product


class AtmosAverages(NamedTuple):
    n: jnp.ndarray
    ast: jnp.ndarray
    hmixa: jnp.ndarray
    wekta: jnp.ndarray
    fnetat: jnp.ndarray
    tauxa: jnp.ndarray
    tauya: jnp.ndarray
    wekpa: jnp.ndarray
    pa: jnp.ndarray
    qa: jnp.ndarray
    uufa: jnp.ndarray     # (nyta, nxpa)
    tufa: jnp.ndarray     # (nyta, nxpa)
    utufa: jnp.ndarray    # (nyta, nxpa)
    vvfa: jnp.ndarray     # (nypa, nxta)
    tvfa: jnp.ndarray     # (nypa, nxta)
    vtvfa: jnp.ndarray    # (nypa, nxta)


def zero_ocean_averages(cfg, dtype) -> OceanAverages:
    zt = jnp.zeros((cfg.nyto, cfg.nxto), dtype)
    zp = jnp.zeros((cfg.nypo, cfg.nxpo), dtype)
    zl = jnp.zeros((cfg.nlo, cfg.nypo, cfg.nxpo), dtype)
    zu = jnp.zeros((cfg.nyto, cfg.nxpo), dtype)
    zv = jnp.zeros((cfg.nypo, cfg.nxto), dtype)
    return OceanAverages(n=jnp.zeros((), dtype), sst=zt, wekto=zt,
                         fnetoc=zt, tauxo=zp, tauyo=zp, wekpo=zp,
                         po=zl, qo=zl, uufo=zu, tufo=zu, utufo=zu,
                         vvfo=zv, tvfo=zv, vtvfo=zv)


def zero_atmos_averages(cfg, dtype) -> AtmosAverages:
    zt = jnp.zeros((cfg.nyta, cfg.nxta), dtype)
    zp = jnp.zeros((cfg.nypa, cfg.nxpa), dtype)
    zl = jnp.zeros((cfg.nla, cfg.nypa, cfg.nxpa), dtype)
    zu = jnp.zeros((cfg.nyta, cfg.nxpa), dtype)
    zv = jnp.zeros((cfg.nypa, cfg.nxta), dtype)
    return AtmosAverages(n=jnp.zeros((), dtype), ast=zt, hmixa=zt,
                         wekta=zt, fnetat=zt, tauxa=zp, tauya=zp,
                         wekpa=zp, pa=zl, qa=zl, uufa=zu, tufa=zu,
                         utufa=zu, vvfa=zv, tvfa=zv, vtvfa=zv)


def _ocean_faces(model, sst, po1, tauxo, tauyo, tsbdy, tnbdy):
    """Face-point (u, T_u, v, T_v) exactly as tavocn builds them
    (timavge.F:486-556), [y, x] layout."""
    cfg = model.cfg
    g = model.grids
    cyclic = cfg.cyclic_ocean
    uvgfac = cfg.ycexp / (g.dxo * cfg.fnot)
    rhf0hm = 0.5 / (cfg.fnot * cfg.mixed.hmoc)

    # u at W/E faces (T rows x p columns)
    uuf = (-uvgfac * (po1[1:, :] - po1[:-1, :])
           + rhf0hm * (tauyo[1:, :] + tauyo[:-1, :]))
    if cyclic:
        twrap = 0.5 * (sst[:, :1] + sst[:, -1:])
        tuf = jnp.concatenate(
            [twrap, 0.5 * (sst[:, :-1] + sst[:, 1:]), twrap], axis=1)
    else:
        tuf = jnp.concatenate(
            [sst[:, :1], 0.5 * (sst[:, :-1] + sst[:, 1:]), sst[:, -1:]],
            axis=1)
        uuf = uuf.at[:, 0].set(0.0).at[:, -1].set(0.0)

    # v at S/N faces (p rows x T columns)
    vvf = (uvgfac * (po1[:, 1:] - po1[:, :-1])
           - rhf0hm * (tauxo[:, 1:] + tauxo[:, :-1]))
    tvf = jnp.concatenate(
        [sst[:1, :], 0.5 * (sst[:-1, :] + sst[1:, :]), sst[-1:, :]],
        axis=0)
    if cfg.sb_hflux:
        vs = -rhf0hm * (tauxo[0, 1:] + tauxo[0, :-1])
        vvf = vvf.at[0].set(vs)
        tvf = tvf.at[0].set(0.5 * (sst[0, :] + tsbdy))
    else:
        vvf = vvf.at[0].set(0.0)
    if cfg.nb_hflux:
        vn = -rhf0hm * (tauxo[-1, 1:] + tauxo[-1, :-1])
        vvf = vvf.at[-1].set(vn)
        tvf = tvf.at[-1].set(0.5 * (sst[-1, :] + tnbdy))
    else:
        vvf = vvf.at[-1].set(0.0)
    return uuf, tuf, vvf, tvf


def _atmos_faces(model, ast, pa1, tauxa, tauya):
    """Face-point (u, T_u, v, T_v) as tavatm builds them
    (timavge.F:340-400). x always periodic; Ekman signs are the
    atmospheric ones (u gets -tau_y/f0 h, v gets +tau_x/f0 h)."""
    cfg = model.cfg
    g = model.grids
    rdxaf0 = 1.0 / (g.dxa * cfg.fnot)
    rhf0hm = 0.5 / (cfg.fnot * cfg.mixed.hmat)

    uuf = (-rdxaf0 * (pa1[1:, :] - pa1[:-1, :])
           - rhf0hm * (tauya[1:, :] + tauya[:-1, :]))
    twrap = 0.5 * (ast[:, :1] + ast[:, -1:])
    tuf = jnp.concatenate(
        [twrap, 0.5 * (ast[:, :-1] + ast[:, 1:]), twrap], axis=1)

    vvf = (rdxaf0 * (pa1[:, 1:] - pa1[:, :-1])
           + rhf0hm * (tauxa[:, 1:] + tauxa[:, :-1]))
    vvf = vvf.at[0].set(0.0).at[-1].set(0.0)
    tvf = jnp.concatenate(
        [ast[:1, :], 0.5 * (ast[:-1, :] + ast[1:, :]), ast[-1:, :]],
        axis=0)
    return uuf, tuf, vvf, tvf


def accumulate_ocean(acc: OceanAverages, state, forcing, model
                     ) -> OceanAverages:
    uuf, tuf, vvf, tvf = _ocean_faces(
        model, state.sst, state.po[0], forcing.tauxo, forcing.tauyo,
        model.rad.tsbdy, model.rad.tnbdy)
    return OceanAverages(
        n=acc.n + 1.0,
        sst=acc.sst + state.sst,
        wekto=acc.wekto + forcing.wekto,
        fnetoc=acc.fnetoc + forcing.fnetoc,
        tauxo=acc.tauxo + forcing.tauxo,
        tauyo=acc.tauyo + forcing.tauyo,
        wekpo=acc.wekpo + forcing.wekpo,
        po=acc.po + state.po,
        qo=acc.qo + state.qo,
        uufo=acc.uufo + uuf, tufo=acc.tufo + tuf,
        utufo=acc.utufo + uuf * tuf,
        vvfo=acc.vvfo + vvf, tvfo=acc.tvfo + tvf,
        vtvfo=acc.vtvfo + vvf * tvf)


def accumulate_atmos(acc: AtmosAverages, state, forcing, model
                     ) -> AtmosAverages:
    uuf, tuf, vvf, tvf = _atmos_faces(
        model, state.ast, state.pa[0], forcing.tauxa, forcing.tauya)
    return AtmosAverages(
        n=acc.n + 1.0,
        ast=acc.ast + state.ast,
        hmixa=acc.hmixa + state.hmixa,
        wekta=acc.wekta + forcing.wekta,
        fnetat=acc.fnetat + forcing.fnetat,
        tauxa=acc.tauxa + forcing.tauxa,
        tauya=acc.tauya + forcing.tauya,
        wekpa=acc.wekpa + forcing.wekpa,
        pa=acc.pa + state.pa,
        qa=acc.qa + state.qa,
        uufa=acc.uufa + uuf, tufa=acc.tufa + tuf,
        utufa=acc.utufa + uuf * tuf,
        vvfa=acc.vvfa + vvf, tvfa=acc.tvfa + tvf,
        vtvfa=acc.vtvfa + vvf * tvf)


def eddy_fluxes(acc):
    """uptp = <uT> - <u><T>, vptp = <vT> - <v><T> (tavout,
    timavge.F:780-796 atmos / 850-870 ocean). Returns NumPy arrays."""
    n = max(float(acc.n), 1.0)
    if isinstance(acc, OceanAverages):
        uu, tu, utu = acc.uufo, acc.tufo, acc.utufo
        vv, tv, vtv = acc.vvfo, acc.tvfo, acc.vtvfo
    else:
        uu, tu, utu = acc.uufa, acc.tufa, acc.utufa
        vv, tv, vtv = acc.vvfa, acc.tvfa, acc.vtvfa
    uu, tu, utu, vv, tv, vtv = (np.asarray(a, np.float64) / n
                                for a in (uu, tu, utu, vv, tv, vtv))
    return utu - uu * tu, vtv - vv * tv


def write_avges(path: str, model, oc_acc: Optional[OceanAverages],
                at_acc: Optional[AtmosAverages]):
    """Divide the accumulated sums by the counts and write avges.nc.
    The ocean variables double as a mean-forcing file for later
    ocean-only runs (q-gcm.F:791-808 reads fnetoc/tauxo/tauyo; the
    atmos-only mode reads sst)."""
    from ..io.ncdf import make_writer as NcWriter
    cfg = model.cfg
    w = NcWriter(path)
    if oc_acc is not None:
        n = max(float(oc_acc.n), 1.0)
        w.dim("xpo", cfg.nxpo); w.dim("ypo", cfg.nypo)
        w.dim("xto", cfg.nxto); w.dim("yto", cfg.nyto)
        w.dim("zo", cfg.nlo)
        for nm in ["sst", "wekto", "fnetoc"]:
            w.var(nm, "d", ("yto", "xto"),
                  data=np.asarray(getattr(oc_acc, nm)) / n)
        for nm in ["tauxo", "tauyo", "wekpo"]:
            w.var(nm, "d", ("ypo", "xpo"),
                  data=np.asarray(getattr(oc_acc, nm)) / n)
        for nm in ["po", "qo"]:
            w.var(nm, "d", ("zo", "ypo", "xpo"),
                  data=np.asarray(getattr(oc_acc, nm)) / n)
        uptpoc, vptpoc = eddy_fluxes(oc_acc)
        w.var("uptpoc", "d", ("yto", "xpo"), data=uptpoc,
              units="K.m/s")
        w.var("vptpoc", "d", ("ypo", "xto"), data=vptpoc,
              units="K.m/s")
    if at_acc is not None:
        n = max(float(at_acc.n), 1.0)
        w.dim("xpa", cfg.nxpa); w.dim("ypa", cfg.nypa)
        w.dim("xta", cfg.nxta); w.dim("yta", cfg.nyta)
        w.dim("za", cfg.nla)
        for nm in ["ast", "hmixa", "wekta", "fnetat"]:
            w.var(nm, "d", ("yta", "xta"),
                  data=np.asarray(getattr(at_acc, nm)) / n)
        for nm in ["tauxa", "tauya", "wekpa"]:
            w.var(nm, "d", ("ypa", "xpa"),
                  data=np.asarray(getattr(at_acc, nm)) / n)
        for nm in ["pa", "qa"]:
            w.var(nm, "d", ("za", "ypa", "xpa"),
                  data=np.asarray(getattr(at_acc, nm)) / n)
        uptpat, vptpat = eddy_fluxes(at_acc)
        w.var("uptpat", "d", ("yta", "xpa"), data=uptpat,
              units="K.m/s")
        w.var("vptpat", "d", ("ypa", "xta"), data=vptpat,
              units="K.m/s")
    w.close()
