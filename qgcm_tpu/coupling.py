"""Air-sea coupling: the xforc forcing computation.

Replaces reference src/xfosubs.F (1734 lines). Computes, from the lagged
model states, the full set of forcing fields:
  * windstress on the ocean-resolution atmospheric grid via quadratic
    drag on the (optionally ocean-relative, tau_udiff) geostrophic wind
    (xfosubs.F:310-355, eqs 7.1-7.4);
  * Ekman velocities on both grids (7.6-7.7) and their boundary
    integrals for the momentum constraints;
  * diabatic (radiative + sensible/latent) mixed-layer forcings
    fnetoc / fnetat (7.8-7.10).

Redesign of the two interpolations:
  * the bicubic refinement of the atmospheric wind (auvbcu/bcuini,
    xfosubs.F:997-1630) is a LINEAR map from the 4x4 coarse-point
    neighbourhood of each coarse cell to its ndxr^2 fine points. We
    precompute the 16-weight tensors on the host (including the
    mixed-BC / cross-coupled boundary variants, where v's wall-normal
    derivative comes from u via continuity) and apply them as one
    batched einsum -- a matmul of shape (ncells,16)x(16,ndxr^2) --
    instead of the reference's per-cell scalar loops.
  * the bilinear AST->ocean-grid map (bilint, xfosubs.F:891-996)
    becomes a gather with precomputed indices/weights.

All reductions (T-cell edge integrals of tau, wekpa box means, the
ocean->atmosphere heat-flux aggregation) are reshape/window sums.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import ModelConfig
from .grids import Grids
from .state import OceanForcing, AtmosForcing


class XforcDiags(NamedTuple):
    """Monitoring scalars (monitor_data.F arlaav/slhfav/oradav/arocav)."""
    arlaav: jnp.ndarray   # mean land AST radiation
    slhfav: jnp.ndarray   # mean sensible+latent heat flux over ocean
    oradav: jnp.ndarray   # mean oceanic IR radiation
    arocav: jnp.ndarray   # mean atmos ML radiation into ocean


# ----------------------------------------------------------------------
# Bicubic weight tensors (host-side; bcuini/wts2bb, xfosubs.F:1238-1630)
# ----------------------------------------------------------------------

def _stinv() -> np.ndarray:
    """Inverse of the bicubic corner-constraint matrix: maps the vector
    {f, fs, ft, fst} at the 4 unit-cell corners to the 16 coefficients
    c_ij of f(s,t) = sum c_ij s^i t^j (the hardwired DATA matrix at
    xfosubs.F:1655-1670, derived here instead of transcribed)."""
    M = np.zeros((16, 16))
    for jp in (0, 1):
        for ip in (0, 1):
            kp = 2 * jp + ip
            s, t = float(ip), float(jp)
            for j in range(4):
                for i in range(4):
                    m = 4 * j + i
                    M[kp, m] = s**i * t**j
                    M[kp + 4, m] = i * s**(i - 1) * t**j if i > 0 else 0.0
                    M[kp + 8, m] = j * s**i * t**(j - 1) if j > 0 else 0.0
                    M[kp + 12, m] = (i * j * s**(i - 1) * t**(j - 1)
                                     if (i > 0 and j > 0) else 0.0)
    return np.linalg.inv(M)


def _wts2bb(wfcn, wfnx, wfny, wfxy, stinv) -> np.ndarray:
    """B matrix: 16 data values -> 16 bicubic coefficients
    (wts2bb, xfosubs.F:1633-1729). Weight arrays are [id+1,jd+1,ip,jp]."""
    u2f = np.zeros((16, 16))
    for jp in (0, 1):
        for ip in (0, 1):
            kp = 2 * jp + ip
            kd = 0
            for jd in range(4):
                for id_ in range(4):
                    u2f[kp, kd] = wfcn[id_, jd, ip, jp]
                    u2f[kp + 4, kd] = wfnx[id_, jd, ip, jp]
                    u2f[kp + 8, kd] = wfny[id_, jd, ip, jp]
                    u2f[kp + 12, kd] = wfxy[id_, jd, ip, jp]
                    kd += 1
    return stinv @ u2f


def _weight_arrays(case: str, bccoat: float, dya: float):
    """Finite-difference weight sets for the five bcuini cases:
    'bbb' interior, 'us'/'un' u near S/N wall (mixed pressure BC),
    'vs'/'vn' v near S/N wall (v_y = -u_x from continuity, taking u
    data from the otherwise-empty jd=-1 / jd=+2 slots)."""
    wfcn = np.zeros((4, 4, 2, 2))
    wfnx = np.zeros((4, 4, 2, 2))
    wfny = np.zeros((4, 4, 2, 2))
    wfxy = np.zeros((4, 4, 2, 2))
    bod = bccoat / dya
    for jp in (0, 1):
        for ip in (0, 1):
            # id/jd are offset by +1 into the arrays (range -1..2)
            I, J = ip + 1, jp + 1
            wfcn[I, J, ip, jp] = 1.0
            wfnx[I + 1, J, ip, jp] = 0.5
            wfnx[I - 1, J, ip, jp] = -0.5
            special = (case in ("us", "vs") and jp == 0) or \
                      (case in ("un", "vn") and jp == 1)
            if not special:
                wfny[I, J + 1, ip, jp] = 0.5
                wfny[I, J - 1, ip, jp] = -0.5
                wfxy[I + 1, J + 1, ip, jp] = 0.25
                wfxy[I - 1, J + 1, ip, jp] = -0.25
                wfxy[I + 1, J - 1, ip, jp] = -0.25
                wfxy[I - 1, J - 1, ip, jp] = 0.25
            elif case == "us":
                wfny[I, J, ip, jp] = bod
                wfxy[I + 1, J, ip, jp] = bod * 0.5
                wfxy[I - 1, J, ip, jp] = -bod * 0.5
            elif case == "un":
                wfny[I, J, ip, jp] = -bod
                wfxy[I + 1, J, ip, jp] = -bod * 0.5
                wfxy[I - 1, J, ip, jp] = bod * 0.5
            elif case == "vs":
                wfny[I + 1, J - 1, ip, jp] = -0.5
                wfny[I - 1, J - 1, ip, jp] = 0.5
                wfxy[I + 1, J - 1, ip, jp] = -1.0
                wfxy[I, J - 1, ip, jp] = 2.0
                wfxy[I - 1, J - 1, ip, jp] = -1.0
            elif case == "vn":
                wfny[I + 1, J + 1, ip, jp] = -0.5
                wfny[I - 1, J + 1, ip, jp] = 0.5
                wfxy[I + 1, J + 1, ip, jp] = -1.0
                wfxy[I, J + 1, ip, jp] = 2.0
                wfxy[I - 1, J + 1, ip, jp] = -1.0
    return wfcn, wfnx, wfny, wfxy


def _bcu_weights(ndxr: int, bccoat: float, dya: float):
    """Fine-point weight tensors W[jd, a, ii, jj]: the contribution of
    coarse point (row offset jd-1, col offset a-1) to fine point
    (ii, jj) of the cell. Interior/south use jj=0..ndxr-1; north
    includes the wall row jj=ndxr."""
    stinv = _stinv()
    ss = np.arange(ndxr + 1) / ndxr
    # stfn[m, ii, jj] = ss[ii]^i * tt[jj]^j, m = 4j + i
    pow_s = ss[None, :] ** np.arange(4)[:, None]          # (4, ndxr+1)
    stfn = (pow_s[None, :, None, :] * pow_s[:, None, :, None])
    # stfn[j_exp, i_exp, jj, ii] -> reshape m = 4*j_exp + i_exp
    stfn = stfn.reshape(16, ndxr + 1, ndxr + 1)           # [m, jj, ii]

    def tensor(case, njj):
        B = _wts2bb(*_weight_arrays(case, bccoat, dya), stinv)  # (16m,16k)
        stb = np.einsum("mji,mk->kij", stfn[:, :njj, :ndxr], B)
        # stb[k, ii, jj] with k = 4*jd + a
        return stb.reshape(4, 4, ndxr, njj)               # [jd, a, ii, jj]

    return (tensor("bbb", ndxr), tensor("us", ndxr), tensor("un", ndxr + 1),
            tensor("vs", ndxr), tensor("vn", ndxr + 1))


def _sep_factors(w: np.ndarray, dtype, max_rank: int = 2):
    """Split W[jd, a, ii, jj] into separable rank terms
    sum_r wy[jd, jj, r] * wx[r, a, ii] (exact: the bicubic of
    tensor-product corner stencils is rank 1; the v-wall variants add
    one continuity term, rank 2 -- asserted here).  Separability is
    what lets the refinement run x-first at coarse-row cost with the
    fine x axis emitted MERGED: the combined 16-tap einsum's
    (band, ndxr, cell, ndxr) output costs ~0.7 ms/atmos-step of
    tile-relayout at double-gyre scale just to reach row-major."""
    jd, a, nii, njj = w.shape
    M = np.asarray(w, np.float64).transpose(0, 3, 1, 2)
    M = M.reshape(jd * njj, a * nii)
    U, s, Vt = np.linalg.svd(M, full_matrices=False)
    r = int((s > 1e-10 * s[0]).sum())
    # bicubic_refine_uv consumes exactly these ranks (the general band
    # uses term 0 only); a construction change that raises the rank
    # must fail HERE, not silently truncate the refinement (a real
    # exception, not an assert: `python -O` strips asserts)
    if r > max_rank:
        raise ValueError(
            f"bicubic weight tensor has separable rank {r} > "
            f"{max_rank}; the refinement would be truncated")
    wy = (U[:, :r] * s[:r]).reshape(jd, njj, r)
    wx = Vt[:r].reshape(r, a, nii)
    return np.asarray(wy, dtype), np.asarray(wx, dtype)


# ----------------------------------------------------------------------
# Static coupling data
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class Coupling:
    """Precomputed operators/factors for xforc, built once on the host."""
    # separable bicubic weight factors: (wy[jd, jj, r], wx[r, a, ii])
    # per bcuini case (see _sep_factors)
    w_bbb: tuple
    w_us: tuple
    w_un: tuple
    w_vs: tuple
    w_vn: tuple
    # bilinear astm -> ocean-T-grid gather
    bil_ix_m: jnp.ndarray    # (nxto,) int
    bil_ix_p: jnp.ndarray
    bil_wx_p: jnp.ndarray    # (nxto,)
    bil_jy_m: jnp.ndarray    # (nyto,) int
    bil_jy_p: jnp.ndarray
    bil_wy_p: jnp.ndarray
    # radiative forcing profiles fsprim at ocean/atmos T latitudes
    fsp_oc: jnp.ndarray      # (nyto,)
    fsp_at: jnp.ndarray      # (nyta,)


def fsprim_profile(cfg: ModelConfig, fspco: float, yrel: np.ndarray,
                   yla: float) -> np.ndarray:
    return fspco * 0.5 * np.sin(np.pi * yrel / yla)


def build_coupling(cfg: ModelConfig, grids: Grids, rad) -> Coupling:
    dtype = jnp.dtype(cfg.dtype)
    w = _bcu_weights(cfg.ndxr, cfg.atmos.bccoat, grids.dya)

    # bilint index/weight vectors (xfosubs.F:920-960): ocean T points in
    # the atmospheric T grid, cyclic x, constant-extrapolation y.
    xa0, ya0 = grids.xta[0], grids.yta[0]
    iam = np.floor(1.0 + (grids.xto - xa0) / grids.dxa).astype(int)  # 1-based
    xam = np.where(iam >= 1, (iam - 1) * grids.dxa + xa0,
                   xa0 - grids.dxa)
    wpx = (grids.xto - xam) / grids.dxa
    ix_m = (iam - 1) % cfg.nxta
    ix_p = iam % cfg.nxta
    jam = np.floor(1.0 + (grids.yto - ya0) / grids.dya).astype(int)
    jap = np.minimum(jam + 1, cfg.nyta)
    jam = np.maximum(jam, 1)
    wpy = (grids.yto - (ya0 + (jam - 1) * grids.dya)) / grids.dya

    fsp_oc = fsprim_profile(cfg, rad.fspco, grids.ytorel, grids.yla)
    fsp_at = fsprim_profile(cfg, rad.fspco, grids.ytarel, grids.yla)

    return Coupling(
        w_bbb=_sep_factors(w[0], dtype, max_rank=1),
        w_us=_sep_factors(w[1], dtype, max_rank=1),
        w_un=_sep_factors(w[2], dtype, max_rank=1),
        w_vs=_sep_factors(w[3], dtype),
        w_vn=_sep_factors(w[4], dtype),
        bil_ix_m=np.asarray(ix_m), bil_ix_p=np.asarray(ix_p),
        bil_wx_p=np.asarray(wpx, dtype=dtype),
        bil_jy_m=np.asarray(jam - 1), bil_jy_p=np.asarray(jap - 1),
        bil_wy_p=np.asarray(wpy, dtype=dtype),
        fsp_oc=np.asarray(fsp_oc, dtype=dtype),
        fsp_at=np.asarray(fsp_at, dtype=dtype),
    )


# ----------------------------------------------------------------------
# Bicubic refinement (auvbcu)
# ----------------------------------------------------------------------

def _xtaps(f: jnp.ndarray) -> jnp.ndarray:
    """(rows, nxta) -> (rows, nxta, 4): taps at columns (c+a-1) mod nxta."""
    return jnp.stack([jnp.roll(f, 1 - a, axis=-1) for a in range(4)],
                     axis=-1)


def _xrefine(taps: jnp.ndarray, wx: jnp.ndarray) -> jnp.ndarray:
    """(rows, nxta, 4 taps) x wx(4, nii) -> (rows, nxta*nii), the fine
    x axis MERGED. The relayout to row-major happens here at
    coarse-row size (a few MB) instead of on the full fine grid."""
    out = jnp.einsum("zca,ai->zci", taps, jnp.asarray(wx),
                     precision="highest")
    return out.reshape(out.shape[0], -1)


def _band_refine(taps_rows: jnp.ndarray, factors) -> jnp.ndarray:
    """Wall band: (4 jd-slots, nxta, 4 taps) -> (njj, nxtaor), summing
    the separable rank terms (rank 2 for the v walls: the continuity
    term takes an x-derivative of the wall-u data)."""
    wy, wx = factors
    out = None
    for r in range(wx.shape[0]):
        X = _xrefine(taps_rows, wx[r])               # (4, m)
        t = jnp.einsum("dm,dj->jm", X, jnp.asarray(wy[:, :, r]),
                       precision="highest")
        out = t if out is None else out + t
    return out


def _footprint_interior(cfg) -> bool:
    """True when the ocean footprint's bicubic bands are all INTERIOR
    bands of the fine atmospheric grid (>= 1 coarse-cell margin to
    each zonal wall), so the window refinement needs only the 'bbb'
    weights. Holds for every example configuration (the ocean is
    centred inside the atmosphere)."""
    jc_lo = cfg.ny1 - 1
    jc_hi = cfg.ny1 - 1 + cfg.nyaooc
    return jc_lo >= 1 and jc_hi <= cfg.nyta - 2


def bicubic_refine_window(coup: Coupling, u1at: jnp.ndarray,
                          v1at: jnp.ndarray, cfg):
    """Refine the coarse velocities directly ONTO the ocean window of
    the fine grid -- (nypo, nxpo) -- without materialising the rest.

    Used by the mesh-sharded xforc: the full fine grid is computed in
    fine-grid sharding for the atmospheric outputs, while the ocean
    windstress needs the same values in OCEAN sharding; slicing the
    sharded fine array at the (joc0, ioc0) offset makes GSPMD
    all-gather it. Recomputing the window from the (replicated,
    atmos-sized) coarse rows is communication-free and costs only
    O(window) extra flops. Same arithmetic as bicubic_refine_uv's
    general bands: x-refine the needed coarse rows, slice the window
    columns, 4-tap y-contract the footprint bands (all interior --
    guarded by _footprint_interior)."""
    ndxr = cfg.ndxr
    nxpo, nypo = cfg.nxpo, cfg.nypo
    ioc0 = (cfg.nx1 - 1) * ndxr
    jc_lo = cfg.ny1 - 1
    nb = cfg.nyaooc + 1            # bands; the last contributes 1 row
    wy_b, wx_b = coup.w_bbb

    def win(f):
        taps = _xtaps(f[:, :-1])
        X = _xrefine(taps, wx_b[0])           # (nypa, nxtaor)
        if ioc0 + nxpo <= X.shape[1]:
            Xw = jax.lax.dynamic_slice_in_dim(X, ioc0, nxpo, axis=1)
        else:                                  # cyclic: duplicate col
            Xw = jnp.concatenate([X[:, ioc0:], X[:, :1]], axis=1)
        Xp = jnp.pad(Xw, ((1, 1), (0, 0)))
        S = jnp.stack([Xp[jc_lo + d: jc_lo + d + nb]
                       for d in range(4)], axis=0)
        wyv = jnp.asarray(wy_b[:, :, 0])
        g = jnp.einsum("dzm,dj->zjm", S, wyv, precision="highest")
        return g.reshape(-1, nxpo)[:nypo]

    return win(u1at), win(v1at)


def bicubic_refine_uv(coup: Coupling, u1at: jnp.ndarray,
                      v1at: jnp.ndarray, ndxr: int):
    """Refine coarse p-grid velocities (nypa, nxpa) to the
    ocean-resolution atmospheric p grid (nypaor, nxpaor).

    Separable form: x-refine the coarse rows first (emitting the fine
    x axis merged), then contract the y taps band-wise -- the big
    (nytaor, nxtaor) array is only ever produced in its final
    row-major layout. The combined 16-tap einsum this replaces emitted
    (band, ndxr_j, cell, ndxr_i) fine grids whose merge cost
    ~0.7 ms/atmos-step of bandwidth-bound relayout (profiled at
    double-gyre scale; the 16-lane minor axis forces tile padding)."""
    nypa = u1at.shape[0]
    nyta = nypa - 1
    U = _xtaps(u1at[:, :-1])                   # (nypa, nxta, 4)
    V = _xtaps(v1at[:, :-1])
    wy_b, wx_b = coup.w_bbb                    # rank 1

    # general bands: x-refine every coarse row once, then y-contract
    Xu = _xrefine(U, wx_b[0])                  # (nypa, m)
    Xv = _xrefine(V, wx_b[0])
    Xup = jnp.pad(Xu, ((1, 1), (0, 0)))
    Xvp = jnp.pad(Xv, ((1, 1), (0, 0)))
    # d-th y-tap of interior bands 1..nyta-2: rows (band-1+d)
    Su = jnp.stack([Xup[d + 1:d + nyta - 1] for d in range(4)], axis=0)
    Sv = jnp.stack([Xvp[d + 1:d + nyta - 1] for d in range(4)], axis=0)
    wyv = jnp.asarray(wy_b[:, :, 0])
    gen_u = jnp.einsum("dzm,dj->zjm", Su, wyv, precision="highest")
    gen_v = jnp.einsum("dzm,dj->zjm", Sv, wyv, precision="highest")
    m = gen_u.shape[-1]

    # south band (jc0 = 0): u pads jd=-1 with zeros, v pads with wall u
    S_u = jnp.concatenate([jnp.zeros_like(U[:1]), U[0:3]], axis=0)
    S_v = jnp.concatenate([U[0:1], V[0:3]], axis=0)
    sou_u = _band_refine(S_u, coup.w_us)
    sou_v = _band_refine(S_v, coup.w_vs)

    # north band (jc0 = nyta-1): jd=+2 slot: zeros for u, wall u for v
    N_u = jnp.concatenate([U[nyta - 2:nyta + 1],
                           jnp.zeros_like(U[:1])], axis=0)
    N_v = jnp.concatenate([V[nyta - 2:nyta + 1], U[nypa - 1:nypa]], axis=0)
    nor_u = _band_refine(N_u, coup.w_un)
    nor_v = _band_refine(N_v, coup.w_vn)

    ufin = jnp.concatenate(
        [sou_u, gen_u.reshape(-1, m), nor_u], axis=0)
    vfin = jnp.concatenate(
        [sou_v, gen_v.reshape(-1, m), nor_v], axis=0)
    ufin = jnp.concatenate([ufin, ufin[:, :1]], axis=1)
    vfin = jnp.concatenate([vfin, vfin[:, :1]], axis=1)
    return ufin, vfin


# ----------------------------------------------------------------------
# Helper reductions
# ----------------------------------------------------------------------

def _line_sum(row: jnp.ndarray) -> jnp.ndarray:
    """p-grid line sum with half end weights."""
    return row[..., 1:-1].sum(-1) + 0.5 * (row[..., 0] + row[..., -1])


def _edge_integrals(field_rows: jnp.ndarray, ndxr: int):
    """Line integrals of a fine-grid field sampled on coarse-aligned
    rows: (nrows, nxtaor+1) -> per-coarse-cell sums with half weights
    at both cell ends (xfosubs.F:370-381)."""
    nxta = (field_rows.shape[-1] - 1) // ndxr
    full = field_rows[..., :-1].reshape(
        field_rows.shape[:-1] + (nxta, ndxr)).sum(-1)
    ends = field_rows[..., ::ndxr]
    return full - 0.5 * ends[..., :-1] + 0.5 * ends[..., 1:]


def _box_mean_to_p(wektaor: jnp.ndarray, ndxr: int, nxpa: int,
                   nypa: int) -> jnp.ndarray:
    """wekpa: weighted box average of the fine T-grid Ekman velocity
    around each coarse p point (xfosubs.F:440-470). Even ndxr: plain
    ndxr x ndxr block mean; odd: half-weighted (ndxr+1)-wide box.
    Cyclic in x, clipped (renormalised) at the N/S walls.

    Even ratios use stride-ndxr window sums directly (output-sized);
    odd ratios need sums at two offsets per axis, via a stride-1 pass.
    """
    half = (ndxr - 1) // 2 + 1
    odd = ndxr % 2 == 1
    # pad: x wraps (always valid), y zero-padded (invalid -> count=0)
    f = jnp.concatenate([wektaor[:, -half:], wektaor,
                         wektaor[:, :half]], axis=1)
    f = jnp.pad(f, ((half, half), (0, 0)))
    cnt = jnp.ones_like(wektaor)
    c = jnp.pad(cnt, ((0, 0), (half, half)), constant_values=1.0)
    c = jnp.pad(c, ((half, half), (0, 0)))

    if not odd:
        def boxs(x):
            return jax.lax.reduce_window(
                x, 0.0, jax.lax.add, (ndxr, ndxr), (ndxr, ndxr),
                "valid")
        return (boxs(f)[:nypa, :nxpa] / boxs(c)[:nypa, :nxpa])

    def box(x):
        return jax.lax.reduce_window(
            x, 0.0, jax.lax.add, (ndxr, ndxr), (1, 1), "valid")

    B, C = box(f), box(c)

    def sample(M, oy, ox):
        return M[oy::ndxr, ox::ndxr][:nypa, :nxpa]

    num = 0.25 * (sample(B, 0, 0) + sample(B, 0, 1)
                  + sample(B, 1, 0) + sample(B, 1, 1))
    den = 0.25 * (sample(C, 0, 0) + sample(C, 0, 1)
                  + sample(C, 1, 0) + sample(C, 1, 1))
    return num / den


def _bilint_ast(coup: Coupling, astm: jnp.ndarray) -> jnp.ndarray:
    """Bilinear astm (nyta,nxta) -> ocean T grid (nyto,nxto)."""
    # jnp.asarray: the weight vectors are host NumPy; a NumPy-NumPy
    # product would bake four (nyto, nxto) constants into the program
    wpx = jnp.asarray(coup.bil_wx_p)[None, :]
    wpy = jnp.asarray(coup.bil_wy_p)[:, None]
    a_mm = astm[coup.bil_jy_m][:, coup.bil_ix_m]
    a_mp = astm[coup.bil_jy_m][:, coup.bil_ix_p]
    a_pm = astm[coup.bil_jy_p][:, coup.bil_ix_m]
    a_pp = astm[coup.bil_jy_p][:, coup.bil_ix_p]
    return ((1 - wpx) * (1 - wpy) * a_mm + wpx * (1 - wpy) * a_mp
            + (1 - wpx) * wpy * a_pm + wpx * wpy * a_pp)


# ----------------------------------------------------------------------
# xforc proper
# ----------------------------------------------------------------------

def make_xforc(model, mesh=None):
    """Build xforc(pam, pom, sstm, astm, hmixam)
    -> (OceanForcing | None, AtmosForcing, XforcDiags).

    pom/sstm may be None in atmos_only mode (then sstm must be the
    prescribed mean SST field instead); pam/astm/hmixam may not.

    With `mesh`, the coupling is laid out to keep every collective
    small (<= the coarse atmospheric grid, which is ndxr^2 times
    smaller than the ocean/fine grids):
      * the coarse inputs u1at/v1at/astm are REPLICATED explicitly
        (three atmos-sized all-gathers per cycle) -- every
        cross-resolution interpolation then reads replicated data and
        is communication-free;
      * the fine-grid stress phase is pinned to the spatial mesh;
      * the ocean windstress is recomputed directly in OCEAN sharding
        from the replicated coarse rows (bicubic_refine_window)
        instead of slicing the sharded fine grid at the footprint
        offset, which GSPMD can only lower as a full-field all-gather.
    tau_udiff scatters the ocean velocity difference INTO the fine
    grid (it feeds wekpa/the atmospheric stress); expressed as a
    static-offset jnp.pad, which GSPMD lowers point-to-point
    (collective-permutes of boundary blocks) rather than the 4
    ocean-sized all-gathers the .at[].add form costs.
    """
    cfg: ModelConfig = model.cfg
    g: Grids = model.grids
    coup: Coupling = model.coupling
    rad = model.rad
    ndxr = cfg.ndxr
    dtype = jnp.dtype(cfg.dtype)

    nxpa, nypa = cfg.nxpa, cfg.nypa
    nxta, nyta = cfg.nxta, cfg.nyta
    nxpo, nypo = cfg.nxpo, cfg.nypo

    rdxaf0 = 1.0 / (g.dxa * cfg.fnot)
    rdxof0 = 1.0 / (g.dxo * cfg.fnot)
    hxafac = 0.5 * rdxaf0
    hxofac = 0.5 * rdxof0
    zbfcat = rdxaf0 / (0.5 * cfg.atmos.bccoat + 1.0)
    zbfcoc = rdxof0 / (0.5 * cfg.ocean.bccooc + 1.0)
    hmat = cfg.mixed.hmat
    uvekfc = 1.0 / (hmat * cfg.fnot * ndxr)
    hmrdxa = hmat / g.dxa
    raoro = cfg.rhoat / cfg.rhooc

    # quadratic-drag coefficients (xfosubs.F:148-160)
    cdhfaa = (cfg.cdat / cfg.fnot) / hmat
    cdhfab = (cfg.cdat / cfg.fnot) * (1.0 / hmat
                                      + raoro / cfg.mixed.hmoc)
    cdrfaa = cfg.cdat / abs(cdhfaa)
    cdrfab = cfg.cdat / abs(cdhfab)
    qu2faa = 4.0 * cdhfaa * cdhfaa
    qu2fab = 4.0 * cdhfab * cdhfab

    # ocean window offsets in the fine grid (0-based)
    ioc0 = (cfg.nx1 - 1) * ndxr
    joc0 = (cfg.ny1 - 1) * ndxr
    # constraint rows jsou/jnor (0-based; xfosubs.F:93)
    jsou = ndxr // 2
    jnor = cfg.nypaor - 1 - ndxr // 2
    ndxodd = ndxr % 2 == 1

    # heat-flux factors (xfosubs.F:770-780)
    ocfrac = (g.dxo * g.dyo) / (g.dxa * g.dya)
    # float() casts: NumPy f64 scalars are strong-typed under x64 and
    # would silently promote the whole f32 forcing pipeline
    fmafac = float(rad.Adown[0, 0]) * 0.25 / cfg.atmos.gpat[0]
    fmatop = 0.25 * (rad.Cmup + rad.C1down)
    hmafac = -cfg.mixed.hmadmp - rad.Bmup - rad.B1down
    dtopat = model.topo.dtopat_or_scalar(dtype)
    dtopat_flat = dtopat.ndim == 0

    xlamda = cfg.mixed.xlamda

    # tau_udiff coefficient masks over the fine grid (xfosubs.F:322-335)
    if cfg.tau_udiff:
        mask = np.zeros((cfg.nypaor, cfg.nxpaor), dtype=bool)
        mask[joc0:joc0 + nypo, ioc0:ioc0 + nxpo] = True
        cdrfac = np.asarray(np.where(mask, cdrfab, cdrfaa), dtype=dtype)
        qu2fac = np.asarray(np.where(mask, qu2fab, qu2faa), dtype=dtype)
    else:
        cdrfac, qu2fac = cdrfaa, qu2faa

    sharded = mesh is not None
    window_path = sharded and not cfg.atmos_only \
        and _footprint_interior(cfg)
    if sharded:
        from jax.sharding import NamedSharding, PartitionSpec as P

        def _repl(f):
            return jax.lax.with_sharding_constraint(
                f, NamedSharding(mesh, P()))

        def _grid(f):
            return jax.lax.with_sharding_constraint(
                f, NamedSharding(mesh, P("y", "x")))

    def _quad_drag(u, v, cdr, qu2):
        """Quadratic-drag windstress (7.1-7.4) from velocities."""
        sp2 = u * u + v * v
        scasqd = -0.5 + 0.5 * jnp.sqrt(1.0 + qu2 * sp2)
        scashr = jnp.sqrt(scasqd)
        cdochi = cdr * scashr / (1.0 + scasqd)
        return cdochi * (u - scashr * v), cdochi * (v + scashr * u)

    def xforc(pam, pom, sstm, astm, hmixam):
        # --- atmospheric geostrophic velocity at p points ---
        pa1 = pam[0]
        u1at = -hxafac * (pa1[2:, :] - pa1[:-2, :])
        u1at = jnp.concatenate([
            (-zbfcat * (pa1[1:2, :] - pa1[0:1, :])),
            u1at,
            (-zbfcat * (pa1[-1:, :] - pa1[-2:-1, :]))], axis=0)
        pe = jnp.concatenate([pa1[:, 1:], pa1[:, 1:2]], axis=1)
        pw = jnp.concatenate([pa1[:, -2:-1], pa1[:, :-1]], axis=1)
        v1at = hxafac * (pe - pw)
        v1at = v1at.at[0, :].set(0.0).at[-1, :].set(0.0)

        if sharded:
            # replicate the coarse velocities (atmos-sized gathers):
            # both the fine-grid refinement and the ocean-window
            # recomputation below then read replicated rows -- no
            # field-sized collective anywhere downstream
            u1at, v1at = _repl(u1at), _repl(v1at)

        u1ator, v1ator = bicubic_refine_uv(coup, u1at, v1at, ndxr)
        if sharded:
            u1ator, v1ator = _grid(u1ator), _grid(v1ator)

        # --- subtract ocean geostrophic velocity (tau_udiff) ---
        u1oc = v1oc = None
        if cfg.tau_udiff and pom is not None:
            # fused where-form over full-shape shifts (the del2_bc
            # idiom): boundary-row/column CONCATS and .at[].set over a
            # mesh-sharded po1 lower as ocean-sized all-gathers; the
            # edge-padded shifts + masks keep every collective a
            # boundary-row halo exchange
            from .ops.stencils import _row_mask, _col_mask
            po1 = pom[0]
            ppy = jnp.pad(po1, ((1, 1), (0, 0)), mode="edge")
            ps, pn = ppy[:-2, :], ppy[2:, :]
            south, north = _row_mask(po1, 0), _row_mask(po1, -1)
            u1oc = jnp.where(
                south, -zbfcoc * (pn - po1),
                jnp.where(north, -zbfcoc * (po1 - ps),
                          -hxofac * (pn - ps)))
            if cfg.cyclic_ocean:
                poe = jnp.concatenate([po1[:, 1:], po1[:, 1:2]], axis=1)
                pow_ = jnp.concatenate([po1[:, -2:-1], po1[:, :-1]],
                                       axis=1)
                v1oc = hxofac * (poe - pow_)
            else:
                ppx = jnp.pad(po1, ((0, 0), (1, 1)), mode="edge")
                pw, pe = ppx[:, :-2], ppx[:, 2:]
                west, east = _col_mask(po1, 0), _col_mask(po1, -1)
                v1oc = jnp.where(
                    west, zbfcoc * (pe - po1),
                    jnp.where(east, zbfcoc * (po1 - pw),
                              hxofac * (pe - pw)))
                u1oc = jnp.where(west | east, 0.0, u1oc)
            # zonal walls: v1oc = 0 there (p const along wall)
            v1oc = jnp.where(south | north, 0.0, v1oc)
            # footprint embedding as a PAD, not .at[].add: GSPMD
            # lowers the static-offset pad point-to-point (6
            # collective-permutes of boundary blocks on the CPU-mesh
            # census) where the dynamic-update-slice form all-gathers
            # the ocean-sized operand 4x per cycle
            widths = ((joc0, cfg.nypaor - joc0 - nypo),
                      (ioc0, cfg.nxpaor - ioc0 - nxpo))
            u1ator = u1ator - jnp.pad(u1oc, widths)
            v1ator = v1ator - jnp.pad(v1oc, widths)

        # --- quadratic-drag windstress on the fine grid (7.1-7.4) ---
        tauxaor, tauyaor = _quad_drag(u1ator, v1ator, cdrfac, qu2fac)

        # --- sample tau onto the coarse atmospheric p grid ---
        tauxa = tauxaor[::ndxr, ::ndxr]
        tauya = tauyaor[::ndxr, ::ndxr]

        # --- Ekman components for amladf (cell-edge integrals) ---
        vekat = uvekfc * _edge_integrals(tauxaor[::ndxr, :], ndxr)
        # uekat: integrate tauy along meridional cell sides
        ucol = _edge_integrals(tauyaor[:, ::ndxr].T, ndxr).T
        uekat = -uvekfc * ucol                      # (nyta, nxpa)
        wekta = -hmrdxa * (uekat[:, 1:] - uekat[:, :-1]
                           + vekat[1:, :] - vekat[:-1, :])

        # --- fine-grid Ekman velocity and wekpa box means (7.6) ---
        wektaor = hxofac * (
            tauyaor[:-1, 1:] + tauyaor[1:, 1:]
            - tauyaor[:-1, :-1] - tauyaor[1:, :-1]
            + tauxaor[:-1, :-1] + tauxaor[:-1, 1:]
            - tauxaor[1:, :-1] - tauxaor[1:, 1:])
        wekpa = _box_mean_to_p(wektaor, ndxr, nxpa, nypa)

        # --- atmospheric momentum-constraint stress integrals ---
        if ndxodd:
            txisat = 0.5 * g.dxo * _line_sum(
                tauxaor[jsou, :] + tauxaor[jsou + 1, :])
            txinat = 0.5 * g.dxo * _line_sum(
                tauxaor[jnor, :] + tauxaor[jnor - 1, :])
        else:
            txisat = g.dxo * _line_sum(tauxaor[jsou, :])
            txinat = g.dxo * _line_sum(tauxaor[jnor, :])

        # --- oceanic stresses and Ekman velocities ---
        ocean_forcing = None
        # the bilinear AST map gathers atmos rows with ocean-grid
        # indices; from a replicated (atmos-sized) operand it is local
        asto = _bilint_ast(coup, _repl(astm) if sharded else astm)
        fsp_o = coup.fsp_oc[:, None]
        ocnrad = rad.D0up * sstm
        slhf = xlamda * (sstm - asto)
        if not cfg.atmos_only:
            if window_path:
                # recompute the window stress in ocean sharding from
                # the replicated coarse rows (same arithmetic as the
                # fine-grid path restricted to the footprint; inside
                # the window the tau_udiff coefficients are uniform)
                u_w, v_w = bicubic_refine_window(coup, u1at, v1at, cfg)
                if u1oc is not None:
                    u_w, v_w = u_w - u1oc, v_w - v1oc
                cdr_w = cdrfab if cfg.tau_udiff else cdrfaa
                qu2_w = qu2fab if cfg.tau_udiff else qu2faa
                tx_w, ty_w = _quad_drag(u_w, v_w, cdr_w, qu2_w)
                tauxo = _grid(raoro * tx_w)
                tauyo = _grid(raoro * ty_w)
            else:
                tauxo = raoro * jax.lax.dynamic_slice(
                    tauxaor, (joc0, ioc0), (nypo, nxpo))
                tauyo = raoro * jax.lax.dynamic_slice(
                    tauyaor, (joc0, ioc0), (nypo, nxpo))
            from .models.ocean import ocean_forcing_from_mean
            atmrad_oc = rad.Dmdown * asto
            fnetoc = -fsp_o - atmrad_oc - ocnrad - slhf
            ocean_forcing = ocean_forcing_from_mean(
                model, tauxo, tauyo, fnetoc)
            arocav = jnp.sum(atmrad_oc) * cfg.ocnorm
        else:
            arocav = jnp.zeros((), dtype=dtype)

        # --- atmospheric diabatic forcing (7.8-7.9) ---
        fnetat = -coup.fsp_at[:, None] - rad.Dmup * astm
        arlasm = jnp.sum(astm) - jnp.sum(
            astm[cfg.ny1 - 1:cfg.ny1 - 1 + cfg.nyaooc,
                 cfg.nx1 - 1:cfg.nx1 - 1 + cfg.nxaooc])
        natlan = nxta * nyta - cfg.nxaooc * cfg.nyaooc
        arlaav = (rad.Dmup * arlasm / natlan if natlan > 0
                  else jnp.zeros((), dtype=dtype))

        # over-ocean contribution, aggregated to atmos cells
        contrib = ocnrad + (rad.Dmdown - rad.Dmup) * asto + slhf
        if sharded:
            # reduce_window instead of reshape().sum(): the reshape
            # across the sharded y axis lowers to an ocean-row-sized
            # all-gather; the windowed reduction moves only boundary
            # rows (summation order differs at ~1e-15 rel)
            blocks = jax.lax.reduce_window(
                contrib, jnp.zeros((), contrib.dtype), jax.lax.add,
                (ndxr, ndxr), (ndxr, ndxr), "valid")
        else:
            blocks = contrib.reshape(cfg.nyaooc, ndxr,
                                     cfg.nxaooc, ndxr).sum((1, 3))
        fnetat = fnetat.at[cfg.ny1 - 1:cfg.ny1 - 1 + cfg.nyaooc,
                           cfg.nx1 - 1:cfg.nx1 - 1 + cfg.nxaooc].set(
            ocfrac * blocks)

        # eta / topography / thickness terms (7.8 first three terms)
        dp12 = pam[0] - pam[1]
        four = (dp12[:-1, :-1] + dp12[:-1, 1:]
                + dp12[1:, :-1] + dp12[1:, 1:])
        if dtopat_flat:
            fourt = 0.0
        else:
            fourt = (dtopat[:-1, :-1] + dtopat[:-1, 1:]
                     + dtopat[1:, :-1] + dtopat[1:, 1:])
        fnetat = (fnetat - fmafac * four - fmatop * fourt
                  + hmafac * (hmixam - hmat))

        atmos_forcing = AtmosForcing(
            tauxa=tauxa, tauya=tauya, fnetat=fnetat,
            wekta=wekta, wekpa=wekpa, uekat=uekat, vekat=vekat,
            txisat=txisat, txinat=txinat)
        diags = XforcDiags(
            arlaav=arlaav,
            slhfav=jnp.sum(slhf) * cfg.ocnorm,
            oradav=jnp.sum(ocnrad) * cfg.ocnorm,
            arocav=arocav)
        return ocean_forcing, atmos_forcing, diags

    return xforc
