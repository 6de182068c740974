"""Covariance statistics -> covar.nc (reference src/covaria_diag.F).

The reference streams spatially-subsampled fields through an
incremental mean/SSP update and writes the packed results at the end
of the run:

- tsampl (covaria_diag.F:359-423): T-grid fields are reduced to BLOCK
  SUMS over nsi x nsi cells (no division -- the subsample vector holds
  sums).
- psampl (:431-488): p-grid fields are reduced to trapezoid-weighted
  sums over (nsi+1) x (nsi+1) point windows that share their edge
  points with the neighbouring blocks (half weights at window edges,
  quarter at corners).
- dssp (:496-600, Algorithm AS 41): streaming update of the mean
  vector and the CORRECTED sum-of-squares-and-products matrix, stored
  packed by lower triangle row-by-row (k = i(i-1)/2 + j, j <= i).
- covout (:241-357) writes covpo/covto/avgpo/avgto/swtpo/swtto (and
  atmos equivalents): the packed UNNORMALISED SSP, the mean, and the
  weight sum.

Vectorised form: same subsampling (vectorised), but the streaming
update is shift-compensated instead of sequential -- we accumulate
deviations d = x - x0 from the first snapshot and the packed outer
products sum_t d_i d_j, then form SSP = sum d_i d_j - s_i s_j / n at
output time, which is algebraically identical to AS41's result while
keeping every step a fused elementwise pass. The packed (triangular)
layout halves the accumulator memory vs a dense (nv, nv) matrix --
required at the reference covariance dims (parameters_data.F:115-119:
e.g. 3600 ocean variables for the canonical configs).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


class CovAccum(NamedTuple):
    n: jnp.ndarray       # scalar count (= reference sumwt with wt=1)
    x0: jnp.ndarray      # (nv,) shift vector (first snapshot) --
                         # accumulating deviations avoids the
                         # catastrophic cancellation of raw moments
    s: jnp.ndarray       # (nv,) running sum of (x - x0)
    ssp: jnp.ndarray     # (nm,) packed lower-triangle sum of d_i d_j


def _tril_rows_cols(nm: int):
    """Row/col indices of the packed lower triangle, computed on device
    (no grid-sized constants in the compiled program): element k of the
    packed vector is (i, j) with j <= i and k = i(i+1)/2 + j."""
    k = jnp.arange(nm)
    i = ((jnp.sqrt(8.0 * k + 1.0) - 1.0) * 0.5).astype(k.dtype)
    # guard the float estimate against off-by-one at triangle starts
    i = jnp.where(i * (i + 1) // 2 > k, i - 1, i)
    i = jnp.where((i + 1) * (i + 2) // 2 <= k, i + 1, i)
    j = k - i * (i + 1) // 2
    return i, j


def subsample_t(field: jnp.ndarray, nsi: int) -> jnp.ndarray:
    """Block sums over nsi x nsi T cells (tsampl), flattened row-major
    (y-major) like the reference's ivs = (js-1)*(nx/nsi) + is."""
    if nsi == 1:
        return field.reshape(-1)
    ny, nx = field.shape
    by, bx = ny // nsi, nx // nsi
    f = field[:by * nsi, :bx * nsi].reshape(by, nsi, bx, nsi)
    return f.sum(axis=(1, 3)).reshape(-1)


def _wsum(x: jnp.ndarray, nsi: int, axis: int) -> jnp.ndarray:
    """Overlapping-window sums of length nsi+1 with stride nsi along
    `axis`, via a cumulative sum (windows share their edge points)."""
    nb = (x.shape[axis] - 1) // nsi
    cs = jnp.cumsum(x, axis=axis)
    zshape = list(x.shape)
    zshape[axis] = 1
    cs = jnp.concatenate([jnp.zeros(zshape, x.dtype), cs], axis=axis)
    hi = jnp.take(cs, jnp.arange(1, nb + 1) * nsi + 1, axis=axis)
    lo = jnp.take(cs, jnp.arange(nb) * nsi, axis=axis)
    return hi - lo


def subsample_p(field: jnp.ndarray, nsi: int) -> jnp.ndarray:
    """Trapezoid-weighted block sums over (nsi+1)^2 p-point windows
    (psampl): half weight on window-edge rows/columns, quarter at
    corners; adjacent windows share their edge points."""
    ny, nx = field.shape
    gy = jnp.where(jnp.arange(ny) % nsi == 0, 0.5, 1.0
                   ).astype(field.dtype)
    gx = jnp.where(jnp.arange(nx) % nsi == 0, 0.5, 1.0
                   ).astype(field.dtype)
    wf = field * gy[:, None] * gx[None, :]
    return _wsum(_wsum(wf, nsi, 0), nsi, 1).reshape(-1)


def cov_size(ny: int, nx: int, nsi: int, grid: str = "t") -> int:
    """Length of the subsample vector (nvcv*); for p grids the window
    count is over the ny-1 x nx-1 cell extent."""
    if grid == "p":
        return ((ny - 1) // nsi) * ((nx - 1) // nsi)
    return (ny // nsi) * (nx // nsi)


def zero_cov(nv: int, dtype=jnp.float64) -> CovAccum:
    nm = nv * (nv + 1) // 2
    return CovAccum(n=jnp.zeros((), dtype),
                    x0=jnp.zeros((nv,), dtype),
                    s=jnp.zeros((nv,), dtype),
                    ssp=jnp.zeros((nm,), dtype))


def accumulate_cov(acc: CovAccum, field: jnp.ndarray, nsi: int,
                   grid: str = "t") -> CovAccum:
    sub = subsample_p if grid == "p" else subsample_t
    x = sub(field, nsi).astype(acc.s.dtype)
    x0 = jnp.where(acc.n == 0, x, acc.x0)
    d = x - x0
    i, j = _tril_rows_cols(acc.ssp.shape[0])
    return CovAccum(n=acc.n + 1.0, x0=x0, s=acc.s + d,
                    ssp=acc.ssp + d[i] * d[j])


def finalize_cov(acc: CovAccum):
    """-> (mean, packed SSP, sumwt) as NumPy arrays. The SSP is the
    reference's covpo/covto content: the UNNORMALISED corrected sum of
    squares and products (AS41), packed by lower triangle."""
    n = float(acc.n)
    s = np.asarray(acc.s, np.float64)
    ssp = np.asarray(acc.ssp, np.float64)
    mean = np.asarray(acc.x0, np.float64) + s / max(n, 1.0)
    if n >= 1:
        nv = s.shape[0]
        i, j = np.tril_indices(nv)
        ssp = ssp - s[i] * s[j] / n
    return mean, ssp, n


def unpack_cov(packed: np.ndarray, nv: int) -> np.ndarray:
    """Packed lower triangle -> dense symmetric matrix (for analysis)."""
    out = np.zeros((nv, nv), np.float64)
    i, j = np.tril_indices(nv)
    out[i, j] = packed
    out[j, i] = packed
    return out


def write_covar(path: str, entries: dict):
    """entries: suffix -> CovAccum (suffixes 'po','to','pa','ta').
    Writes cov<sfx>, avg<sfx>, swt<sfx> in the reference covar.nc
    schema (covout, covaria_diag.F:241-357)."""
    from ..io.ncdf import make_writer as NcWriter
    w = NcWriter(path)
    w.dim("s", 1)
    sides = {"a": [], "o": []}
    for sfx in entries:
        sides[sfx[-1] if sfx[-1] in "ao" else "o"].append(sfx)
    dims_done = set()
    for sfx, acc in entries.items():
        mean, ssp, swt = finalize_cov(acc)
        nv = mean.shape[0]
        fluid = "at" if sfx.endswith("a") else "oc"
        nvd, nmd = f"nvcv{fluid}", f"nmcv{fluid}"
        if nvd not in dims_done:
            w.dim(nvd, nv)
            w.dim(nmd, nv * (nv + 1) // 2)
            dims_done.add(nvd)
        w.var(f"cov{sfx}", "f", (nmd,), data=ssp)
        w.var(f"avg{sfx}", "f", (nvd,), data=mean)
        w.var(f"swt{sfx}", "f", ("s",), data=np.array([swt]))
    w.close()
