"""Finite-difference stencils on the C-grid p-array.

Array convention throughout the package: fields are [..., y, x]
(x last = the contiguous dimension). A p-grid field has shape (..., nyp, nxp).
In the cyclic (channel) case column x=nxp-1 duplicates column x=0.

Implementation note: boundary conditions are applied with `jnp.where`
row/column masks on full-size shifted expressions rather than
`.at[].set` updates -- XLA fuses the mask selects into the stencil
kernel, whereas each dynamic-update-slice materialises a full-array
copy.

Reference semantics:
  del2_bc     -- src/qgosubs.F:94-127 (mixed BCs via bcfac, or cyclic-x)
  jacobian9   -- Arakawa 9-point energy/enstrophy-conserving J(q,p),
                 src/qgosubs.F:374-389 (interior), :354-368 (cyclic west)
"""

from __future__ import annotations

import jax.numpy as jnp


def _wshift(f: jnp.ndarray) -> jnp.ndarray:
    """x-west neighbour for a cyclic p-array (column -1 duplicates 0):
    west of column 0 is column nx-2 (= nxp-2)."""
    return jnp.concatenate([f[..., -2:-1], f[..., :-1]], axis=-1)


def _eshift(f: jnp.ndarray) -> jnp.ndarray:
    """x-east neighbour for a cyclic p-array: east of column nxp-1
    (duplicate of 0) is column 1."""
    return jnp.concatenate([f[..., 1:], f[..., 1:2]], axis=-1)


def _row_mask(f: jnp.ndarray, j: int) -> jnp.ndarray:
    """Boolean (ny, 1) mask selecting row j (negative ok)."""
    ny = f.shape[-2]
    idx = jnp.arange(ny)
    return ((idx == (j % ny)))[:, None]


def _col_mask(f: jnp.ndarray, i: int) -> jnp.ndarray:
    nx = f.shape[-1]
    idx = jnp.arange(nx)
    return (idx == (i % nx))[None, :]


def _pad_edge(f: jnp.ndarray) -> jnp.ndarray:
    """One ghost ring, edge-replicated (garbage values at the ring are
    masked away by the caller)."""
    nd = f.ndim
    return jnp.pad(f, [(0, 0)] * (nd - 2) + [(1, 1), (1, 1)],
                   mode="edge")


def interior_5pt(f: jnp.ndarray, dxm2: float) -> jnp.ndarray:
    """5-point Laplacian on the interior; returns (..., ny-2, nx-2)."""
    return dxm2 * (f[..., :-2, 1:-1] + f[..., 2:, 1:-1]
                   + f[..., 1:-1, :-2] + f[..., 1:-1, 2:]
                   - 4.0 * f[..., 1:-1, 1:-1])


def del2_bc(p: jnp.ndarray, bcfac: float, dxm2: float,
            cyclic: bool) -> jnp.ndarray:
    """Laplacian of a p-field with mixed boundary conditions.

    On solid boundaries the tangential second derivative vanishes
    (p constant along the wall) and the normal second derivative is the
    mixed condition bcfac*(p_inner - p_wall) (src/qgosubs.F:96-126).
    Box: all four walls solid. Cyclic: W/E periodic, N/S solid.
    Output has the same shape as p.
    """
    if cyclic:
        pw, pe = _wshift(p), _eshift(p)
        pp = jnp.pad(p, [(0, 0)] * (p.ndim - 2) + [(1, 1), (0, 0)],
                     mode="edge")
        ps, pn = pp[..., :-2, :], pp[..., 2:, :]      # y-neighbours
        lap = dxm2 * (ps + pn + pw + pe - 4.0 * p)
        bcs = bcfac * (pn - p)        # valid on the south row
        bcn = bcfac * (ps - p)        # valid on the north row
        south = _row_mask(p, 0)
        north = _row_mask(p, -1)
        return jnp.where(south, bcs, jnp.where(north, bcn, lap))

    pp = _pad_edge(p)
    ps, pn = pp[..., :-2, 1:-1], pp[..., 2:, 1:-1]
    pw, pe = pp[..., 1:-1, :-2], pp[..., 1:-1, 2:]
    lap = dxm2 * (ps + pn + pw + pe - 4.0 * p)
    south, north = _row_mask(p, 0), _row_mask(p, -1)
    west, east = _col_mask(p, 0), _col_mask(p, -1)
    out = jnp.where(west, bcfac * (pe - p),
                    jnp.where(east, bcfac * (pw - p), lap))
    out = jnp.where(south, bcfac * (pn - p),
                    jnp.where(north, bcfac * (ps - p), out))
    return out


def jacobian9(q: jnp.ndarray, p: jnp.ndarray, cyclic: bool) -> jnp.ndarray:
    """Arakawa 9-point Jacobian sum J(q,p)*(12 dx dy) (unscaled; multiply
    by adfac = 1/(12 dx dy f0) for the PV tendency contribution).

    Interior formula src/qgosubs.F:378-388. Zonal boundary rows are left
    zero (updated later from the boundary PV relations). In the box case
    the W/E columns are zero; in the cyclic case they use wraparound.
    Output has the same shape as q/p.
    """
    nd = q.ndim
    if cyclic:
        def nbrs(f):
            fp = jnp.pad(f, [(0, 0)] * (nd - 2) + [(1, 1), (0, 0)])
            return (_eshift(f), _wshift(f), fp[..., 2:, :],
                    fp[..., :-2, :],
                    _eshift(fp[..., 2:, :]), _wshift(fp[..., 2:, :]),
                    _eshift(fp[..., :-2, :]), _wshift(fp[..., :-2, :]))
        zero_we = False
    else:
        def nbrs(f):
            fp = jnp.pad(f, [(0, 0)] * (nd - 2) + [(1, 1), (1, 1)])
            return (fp[..., 1:-1, 2:], fp[..., 1:-1, :-2],
                    fp[..., 2:, 1:-1], fp[..., :-2, 1:-1],
                    fp[..., 2:, 2:], fp[..., 2:, :-2],
                    fp[..., :-2, 2:], fp[..., :-2, :-2])
        zero_we = True

    qe, qw, qn, qs, qne, qnw, qse, qsw = nbrs(q)
    pe, pw, pn, ps, pne, pnw, pse, psw = nbrs(p)
    jac = (
        (qe - qw) * (pn - ps)
        + (qs - qn) * (pe - pw)
        + qe * (pne - pse)
        - qw * (pnw - psw)
        - qn * (pne - pnw)
        + qs * (pse - psw)
        + pn * (qne - qnw)
        - ps * (qse - qsw)
        - pe * (qne - qse)
        + pw * (qnw - qsw)
    )
    edge = _row_mask(q, 0) | _row_mask(q, -1)
    if zero_we:
        edge = edge | _col_mask(q, 0) | _col_mask(q, -1)
    return jnp.where(edge, 0.0, jac)
