"""Modified-Helmholtz solvers for the PV inversion.

The reference (src/ocisubs.F:415-618, src/atisubs.F:301-400) solves
  del^2(p) - rdm2 * p = rhs          (5-point FD Laplacian)
with p = 0 on zonal boundaries (and meridional boundaries in the box
case; periodic-x in the channel case) by an x-transform (DST-I for the
box, real FFT for the channel) followed by a *sequential* Thomas solve
along y for every wavenumber.

Redesign: the y-direction tridiagonal has CONSTANT
coefficients (off-diagonal 1/dy^2, diagonal depending only on the x
wavenumber), so it is itself diagonalised by a DST-I in y. We therefore
do a full 2-D transform solve:

    p = T^-1 [ T(rhs) / (lam_x + lam_y - rdm2) ]

with lam_x(k) = 2/dx^2 (cos(k pi/nx) - 1)        (box, DST-I)
            or  2/dx^2 (cos(2 pi k/nx) - 1)       (channel, RFFT)
and  lam_y(l) = 2/dy^2 (cos(l pi/ny) - 1)         (DST-I, Dirichlet).

This is the SAME discrete solution (exact arithmetic) as the reference's
transform+tridiagonal method, but is entirely batched transforms --
no sequential y recurrence of ~1000 tiny dependent steps. Transforms
batch over modes and solve both fluids' inversions in
one fused jit region.

A Thomas-algorithm variant (`thomas_solve`) is retained for
cross-validation in the test suite.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


# DST backends of the spectral solves. 'fft' (XLA's FFT, cuFFT on the
# GPU) is the model's: on an H100 (700 W) it beat the float32
# sine-matrix matmul at every production width -- ms per 3-mode
# solve, FFT vs matmul: 575^2 0.194 vs 0.257, 959^2 0.327 vs 0.653,
# 1919^2 1.06 vs 2.63, 4799^2 5.83 vs 24.8, and the 4609x577
# channel's y transform 0.648 vs 0.688 (tools/bench_packed_sweep.py,
# PERF.md). 'matmul' serves distributed adjoints, whose FFT transpose
# fails under GSPMD in float64 and loses accuracy in float32 on H100s
# (adjoint.ocean_sensitivity picks it on a mesh).
DST_BACKENDS = ("fft", "matmul")

# The sine-matrix products run at full float32 precision: TF32 tensor
# cores would put a float32 solve 4e-4 from a float64 one on an H100,
# against 1e-6 at full precision (PERF.md).
_HIGHEST = jax.lax.Precision.HIGHEST


def _sine_matrix(n: int, dtype) -> jnp.ndarray:
    """The (n, n) DST-I matrix S[k,j] = 2 sin(pi (j+1)(k+1)/(n+1)),
    generated ON THE FLY from iota inside the jitted program: a
    materialised closure constant would be embedded in the compiled
    executable (92 MB at NAtl scale); the sin() generation is a single
    cheap fusion that XLA hoists out of the scan loop."""
    j = jax.lax.iota(dtype, n) + 1.0
    return 2.0 * jnp.sin(
        jnp.asarray(np.pi / (n + 1), dtype) * j[:, None] * j[None, :])


# Below this half-size, stop even/odd splitting: smaller GEMMs lose
# more efficiency than the halved FLOPs gain. On an H100 (700 W) 240
# and 480 differ by at most 0.21 ms per solve from 575^2 to 4799^2,
# neither winning everywhere (tools/bench_packed_sweep.py --splits
# 240,480).
_MM_SPLIT_MIN = 240

def _mm(x: jnp.ndarray, K: jnp.ndarray, axis: int, prec) -> jnp.ndarray:
    """Contract `axis` of x with the FIRST axis of kernel K, keeping
    the axis order of x. axis=-2 is expressed as a direct dot_general
    (kernel on the left, x minor dim rides as the GEMM N dimension) so
    every operand and result keeps the natural x-minor layout -- a
    swapaxes formulation makes XLA propagate transposed layouts into
    the surrounding step (relayout copies)."""
    if axis in (-1, x.ndim - 1):
        return jnp.einsum("...j,jk->...k", x, K, precision=prec)
    assert axis in (-2, x.ndim - 2)
    return jnp.einsum("jk,...jx->...kx", K, x, precision=prec)


def _dst1_mm(x: jnp.ndarray, axis: int, prec=_HIGHEST) -> jnp.ndarray:
    """DST-I along `axis` (-1 or -2) as matmuls, with a radix-2
    even/odd symmetry split while the half-size stays large.

    With M = N+1, the part of x symmetric under j -> M-j feeds only
    ODD wavenumbers through the (m x m) kernel sin(pi j (2t+1)/2m)
    (m = M/2, midpoint folded in at half weight), and the
    antisymmetric part feeds EVEN wavenumbers through a half-size
    DST-I -- which recurses. Each level halves the matmul FLOPs; the
    arithmetic is the textbook DST-I radix-2 step, expressed as dense
    half-kernels (GEMMs) instead of butterflies.
    """
    n = x.shape[axis]
    dt = x.dtype
    m = (n + 1) // 2
    if n % 2 == 0 or m < _MM_SPLIT_MIN:
        return _mm(x, _sine_matrix(n, dt), axis, prec)

    def sl(a, lo, hi):
        return jax.lax.slice_in_dim(a, lo, hi, axis=axis)

    xf = jnp.flip(x, axis)
    e = 0.5 * (sl(x, 0, m - 1) + sl(xf, 0, m - 1))
    o = 0.5 * (sl(x, 0, m - 1) - sl(xf, 0, m - 1))
    ebar = jnp.concatenate([e, 0.5 * sl(x, m - 1, m)], axis=axis)
    j = jax.lax.iota(dt, m) + 1.0                       # 1..m
    t = jax.lax.iota(dt, m)                             # k = 2t+1
    K1 = jnp.sin(jnp.asarray(np.pi / (2 * m), dt)
                 * j[:, None] * (2.0 * t[None, :] + 1.0))
    odd = 4.0 * _mm(ebar, K1, axis, prec)
    even = 2.0 * _dst1_mm(o, axis, prec)                # DST-I size m-1
    # interleave odd/even coefficients along `axis`
    ax = axis if axis >= 0 else x.ndim + axis
    inter = jnp.stack([sl(odd, 0, m - 1), even], axis=ax + 1)
    inter = inter.reshape(x.shape[:ax] + (2 * (m - 1),)
                          + x.shape[ax + 1:])
    return jnp.concatenate([inter, sl(odd, m - 1, m)], axis=axis)


def dst1_matmul(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """DST-I as dense sine-kernel products. Same transform as `dst1`;
    the solvers' packed variant is BoxHelmholtz(transform='matmul')."""
    prec = _HIGHEST
    if axis >= 0:
        axis -= x.ndim
    if axis in (-1, -2):
        return _dst1_mm(x, axis, prec)
    x2 = jnp.moveaxis(x, axis, -1)
    return jnp.moveaxis(_dst1_mm(x2, -1, prec), -1, axis)


# ----------------------------------------------------------------------
# Packed-order split transforms (the BoxHelmholtz 'matmul' hot path)
#
# The radix split's natural output is [odd wavenumbers; even packed
# recursively]; _dst1_mm interleaves it back to wavenumber order, and
# the inverse pass has to un-interleave -- data formatting and reverse
# traffic. Since everything done
# in spectral space (denominator division, Parseval contractions with
# gx/gy, rank-one constraint corrections) is diagonal or a full
# contraction, the solver instead keeps spectra PERMUTED in split
# order: the O(N) eigenvalue/weight vectors are permuted once at
# build time (_split_perm), the forward transform skips the
# interleave, and the inverse applies the exact transpose of the
# forward algorithm (DST-I is symmetric, so DST o P^T = (P o DST)^T).
# ----------------------------------------------------------------------

def _split_perm(n: int) -> np.ndarray:
    """Wavenumber permutation of the packed split order: packed[i] =
    natural[_split_perm(n)[i]]. Mirrors _dst1_mm_packed's recursion
    decisions exactly (odd length and half-size >= _MM_SPLIT_MIN)."""
    m = (n + 1) // 2
    if n % 2 == 0 or m < _MM_SPLIT_MIN:
        return np.arange(n)
    return np.concatenate([2 * np.arange(m),
                           2 * _split_perm(m - 1) + 1])


def _mm_t(y: jnp.ndarray, K: jnp.ndarray, axis: int, prec) -> jnp.ndarray:
    """Contract `axis` of y with the SECOND axis of K (K^T apply)."""
    if axis in (-1, y.ndim - 1):
        return jnp.einsum("...t,jt->...j", y, K, precision=prec)
    assert axis in (-2, y.ndim - 2)
    return jnp.einsum("jt,...tx->...jx", K, y, precision=prec)


def _odd_kernel2(m: int, dtype) -> jnp.ndarray:
    """(m-1, m) kernel K2[j, t] = 2 sin(pi (j+1) (2t+1) / 2m) for
    j = 1..m-1.  The factor 2 absorbs the textbook radix step's
    4 * K1 * (0.5-weighted symmetric parts): with K2 the packed
    transforms below need NO standalone scale or halving passes.

    The midpoint row j = m is NOT in the kernel: its entries are
    2 sin(pi (2t+1)/2) = 2 (-1)^t exactly, so the midpoint column's
    contribution is applied as a fused elementwise epilogue
    (_mid_signs) instead of a full-array concat feeding the GEMM."""
    j = jax.lax.iota(dtype, m - 1) + 1.0
    t = jax.lax.iota(dtype, m)
    return 2.0 * jnp.sin(jnp.asarray(np.pi / (2 * m), dtype)
                         * j[:, None] * (2.0 * t[None, :] + 1.0))


def _mid_signs(m: int, dtype, axis: int, ndim: int) -> jnp.ndarray:
    """2 (-1)^t, t = 0..m-1, shaped to broadcast along `axis`."""
    t = jax.lax.iota(dtype, m)
    s = 2.0 - 4.0 * (t % 2.0)
    if axis in (-2, ndim - 2):
        return s[:, None]
    return s


def _dst1_mm_packed(x: jnp.ndarray, axis: int, prec) -> jnp.ndarray:
    """Split-order DST-I: returns the spectrum permuted by
    _split_perm (no interleave -- odd block then packed even block).

    Scale-free formulation: with xf/xb the front half and the REVERSED
    back half (only n/2 elements flipped), odd = K2 @ [xf+xb; x_mid]
    and even = packedDST(xf - xb) -- by linearity this equals the
    textbook 4*K1*(0.5(xf+xb)) / 2*DST(0.5(xf-xb)) form with every
    elementwise scale folded into the generated kernel."""
    n = x.shape[axis]
    dt = x.dtype
    m = (n + 1) // 2
    if n % 2 == 0 or m < _MM_SPLIT_MIN:
        return _mm(x, _sine_matrix(n, dt), axis, prec)

    def sl(a, lo, hi):
        return jax.lax.slice_in_dim(a, lo, hi, axis=axis)

    xf = sl(x, 0, m - 1)
    xb = jnp.flip(sl(x, m, n), axis)
    odd = (_mm(xf + xb, _odd_kernel2(m, dt), axis, prec)
           + sl(x, m - 1, m) * _mid_signs(m, dt, axis, x.ndim))
    even = _dst1_mm_packed(xf - xb, axis, prec)
    return jnp.concatenate([odd, even], axis=axis)


def _idst1_mm_packed(y: jnp.ndarray, axis: int, prec) -> jnp.ndarray:
    """DST-I of a SPLIT-ORDER spectrum: computes DST(P^T y) as the
    exact transpose of _dst1_mm_packed's algorithm (same matmul count;
    the un-interleave becomes symmetric/antisymmetric reassembly):
    u = K2^T y_odd, v = packedIDST(y_even), result =
    [u_front + v; u_mid; rev(u_front - v)]."""
    n = y.shape[axis]
    dt = y.dtype
    m = (n + 1) // 2
    if n % 2 == 0 or m < _MM_SPLIT_MIN:
        return _mm(y, _sine_matrix(n, dt), axis, prec)

    def sl(a, lo, hi):
        return jax.lax.slice_in_dim(a, lo, hi, axis=axis)

    yo = sl(y, 0, m)
    uf = _mm_t(yo, _odd_kernel2(m, dt), axis, prec)
    um = jnp.sum(yo * _mid_signs(m, dt, axis, y.ndim), axis=axis,
                 keepdims=True)
    v = _idst1_mm_packed(sl(y, m, n), axis, prec)
    return jnp.concatenate([uf + v, um, jnp.flip(uf - v, axis)],
                           axis=axis)


def _split_sizes(n: int) -> list:
    """Packed-order spectral block lengths [m, ...recurse(m-1)] --
    the segment structure of _split_perm / _dst1_mm_packed."""
    m = (n + 1) // 2
    if n % 2 == 0 or m < _MM_SPLIT_MIN:
        return [n]
    return [m] + _split_sizes(m - 1)


def _dst1_mm_blocks(x: jnp.ndarray, axis: int, prec) -> list:
    """Split-order DST-I as a LIST of spectral blocks (one per split
    level, base last): jnp.concatenate(blocks, axis) equals
    _dst1_mm_packed(x, axis).  Skipping the inter-level concatenation
    matters on the minor axis, where the odd/even block boundary is
    not tile-aligned."""
    n = x.shape[axis]
    dt = x.dtype
    m = (n + 1) // 2
    if n % 2 == 0 or m < _MM_SPLIT_MIN:
        return [_mm(x, _sine_matrix(n, dt), axis, prec)]

    def sl(a, lo, hi):
        return jax.lax.slice_in_dim(a, lo, hi, axis=axis)

    xf = sl(x, 0, m - 1)
    xb = jnp.flip(sl(x, m, n), axis)
    odd = (_mm(xf + xb, _odd_kernel2(m, dt), axis, prec)
           + sl(x, m - 1, m) * _mid_signs(m, dt, axis, x.ndim))
    return [odd] + _dst1_mm_blocks(xf - xb, axis, prec)


def _idst1_mm_blocks(blocks: list, axis: int, prec) -> jnp.ndarray:
    """DST-I of a split-order spectrum given as a block list (the
    exact transpose of _dst1_mm_blocks; same arithmetic as
    _idst1_mm_packed minus the input slicing)."""
    y0 = blocks[0]
    dt = y0.dtype
    m = y0.shape[axis]
    if len(blocks) == 1:
        return _mm(y0, _sine_matrix(m, dt), axis, prec)
    uf = _mm_t(y0, _odd_kernel2(m, dt), axis, prec)
    um = jnp.sum(y0 * _mid_signs(m, dt, axis, y0.ndim), axis=axis,
                 keepdims=True)
    v = _idst1_mm_blocks(blocks[1:], axis, prec)
    return jnp.concatenate([uf + v, um, jnp.flip(uf - v, axis)],
                           axis=axis)


def dst1(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Unnormalised type-I discrete sine transform along `axis`.

    X_k = 2 * sum_{j=1..N} x_j sin(pi j k / (N+1)),  k = 1..N
    (FFTPACK `dsint` convention, so dst1(dst1(x)) == 2*(N+1)*x.)

    Implemented via an odd extension of length 2(N+1) and a real FFT --
    XLA lowers this to its batched FFT (cuFFT on the GPU).
    """
    x = jnp.moveaxis(x, axis, -1)
    n = x.shape[-1]
    zero = jnp.zeros(x.shape[:-1] + (1,), dtype=x.dtype)
    z = jnp.concatenate([zero, x, zero, -x[..., ::-1]], axis=-1)
    X = -jnp.fft.rfft(z, axis=-1).imag[..., 1 : n + 1].astype(x.dtype)
    return jnp.moveaxis(X, -1, axis)


def dst1_np(x: np.ndarray, axis: int = -1) -> np.ndarray:
    """NumPy twin of `dst1` for host-side float64 (init-time) solves."""
    x = np.moveaxis(np.asarray(x, dtype=np.float64), axis, -1)
    n = x.shape[-1]
    z = np.zeros(x.shape[:-1] + (2 * (n + 1),), dtype=np.float64)
    z[..., 1:n + 1] = x
    z[..., n + 2:] = -x[..., ::-1]
    X = -np.fft.rfft(z, axis=-1).imag[..., 1:n + 1]
    return np.moveaxis(X, -1, axis)


def thomas_solve(diag: jnp.ndarray, offdiag: float, rhs: jnp.ndarray):
    """Sequential tridiagonal solve along axis -2 (y), vectorised over the
    trailing axis. diag: (..., nx) per-column constant diagonal;
    rhs: (..., ny, nx). Used only for validating the spectral solver."""

    def fwd(carry, r):
        betinv, u_prev = carry
        gam = offdiag * betinv
        betinv_new = 1.0 / (diag - offdiag * gam)
        u = (r - offdiag * u_prev) * betinv_new
        return (betinv_new, u), (gam, u)

    betinv0 = 1.0 / diag
    u0 = rhs[..., 0, :] * betinv0
    (_, _), (gams, us) = jax.lax.scan(
        fwd, (betinv0, u0), jnp.moveaxis(rhs[..., 1:, :], -2, 0))
    us = jnp.concatenate([u0[None], us], axis=0)
    gams = jnp.concatenate([jnp.zeros_like(u0)[None], gams], axis=0)

    def bwd(u_next, inp):
        g_next, u = inp
        u_new = u - g_next * u_next
        return u_new, u_new

    _, xs = jax.lax.scan(
        bwd, us[-1], (gams[1:][::-1], us[:-1][::-1]))
    sol = jnp.concatenate([xs[::-1], us[-1][None]], axis=0)
    return jnp.moveaxis(sol, 0, -2)


@dataclass(frozen=True)
class BoxHelmholtz:
    """Solver for the finite-box domain (Dirichlet on all boundaries).

    Grid: p-array of shape (nyp, nxp); interior unknowns are
    (nyp-2) x (nxp-2) = (ny-1) x (nx-1) where nx=nxp-1 cells.
    """

    nxp: int
    nyp: int
    lamx: jnp.ndarray        # (nxp-2,) x-eigenvalues
    lamy: jnp.ndarray        # (nyp-2,)
    rdm2: jnp.ndarray        # (nm,)
    gx: jnp.ndarray          # (nxp-2,) DST of the ones vector
    gy: jnp.ndarray          # (nyp-2,)
    norm: float              # combined inverse-transform normalisation
    denom_inv_np: np.ndarray = None   # float64 host copy (init-time solves)
    transform: str = "fft"   # 'fft' (odd-extension rfft) | 'matmul'

    # The spectral denominators are recomputed on the fly from the O(N)
    # eigenvalue vectors: a (nm, ny, nx) closure constant would be
    # embedded in the compiled program (hundreds of MB at NAtl.1km
    # scale).
    # The fields are host NumPy (byte-stable programs, no lowering
    # fetch), so they MUST be wrapped in jnp.asarray before the outer
    # sum -- NumPy would otherwise broadcast eagerly at trace time and
    # bake the full (nm, ny, nx) array in as a constant anyway
    # (tests/test_helmholtz.py::test_no_grid_sized_constants).
    def _denom(self):
        return (jnp.asarray(self.lamx)[None, None, :]
                + jnp.asarray(self.lamy)[None, :, None]
                - jnp.asarray(self.rdm2)[:, None, None])

    # With transform='matmul' the spectral space is PERMUTED into the
    # radix split's packed order (odd block, then even recursively) --
    # the lamx/lamy/gx/gy vectors are permuted to match at build time,
    # so denominator division and Parseval contractions are unchanged,
    # while the transforms skip the interleave/un-interleave passes.
    def forward(self, rhs: jnp.ndarray) -> jnp.ndarray:
        """Interior 2-D DST of a p-grid field (packed spectral order
        under transform='matmul')."""
        f = rhs[..., 1:-1, 1:-1]
        if self.transform == "matmul":
            return _dst1_mm_packed(_dst1_mm_packed(f, -1, _HIGHEST), -2,
                                   _HIGHEST)
        return dst1(dst1(f, axis=-1), axis=-2)

    def inverse(self, spec: jnp.ndarray) -> jnp.ndarray:
        if self.transform == "matmul":
            sol = _idst1_mm_packed(_idst1_mm_packed(spec, -1, _HIGHEST),
                                   -2, _HIGHEST) * self.norm
        else:
            sol = dst1(dst1(spec, axis=-1), axis=-2) * self.norm
        return jnp.pad(sol, [(0, 0)] * (spec.ndim - 2) + [(1, 1), (1, 1)])

    def solve_spec(self, rhs: jnp.ndarray) -> jnp.ndarray:
        """Forward transform + denominator division (no inverse)."""
        return self.forward(rhs) / self._denom()

    def solve(self, rhs: jnp.ndarray) -> jnp.ndarray:
        """rhs: (nm, nyp, nxp); returns solution with zero boundaries."""
        return self.inverse(self.solve_spec(rhs))

    # -- block (tree) spectral interface: matmul backend only ---------
    # The packed spectrum's split levels stay SEPARATE arrays, so the
    # forward transforms skip the inter-level concatenations and the
    # inverse skips the input slicing.  The spectral algebra consumers
    # (_ocinvq box path) iterate the static (x-block, y-block) grid
    # with segment views of the permuted lamx/lamy/gx/gy vectors.
    @property
    def supports_blocks(self) -> bool:
        return self.transform == "matmul"

    def block_sizes(self):
        """(xsizes, ysizes): packed spectral segment lengths."""
        return (_split_sizes(self.nxp - 2), _split_sizes(self.nyp - 2))

    def block_algebra(self):
        """Per-(x-block, y-block) spectral algebra pieces for the tree
        form: nested lists denom[i][j] (same lamx + lamy - rdm2 as
        _denom(), on segment views of the PERMUTED vectors) plus the
        Parseval weight segments gx[i], gy[j]. Keeps the packed-split
        layout knowledge in the solver -- consumers (_ocinvq) iterate
        blocks without re-deriving segment offsets."""
        xsizes, ysizes = self.block_sizes()
        xoff = np.concatenate([[0], np.cumsum(xsizes)])
        yoff = np.concatenate([[0], np.cumsum(ysizes)])
        lamx = jnp.asarray(self.lamx)
        lamy = jnp.asarray(self.lamy)
        rdm2 = jnp.asarray(self.rdm2)
        gxs = [jnp.asarray(self.gx)[xoff[i]:xoff[i + 1]]
               for i in range(len(xsizes))]
        gys = [jnp.asarray(self.gy)[yoff[j]:yoff[j + 1]]
               for j in range(len(ysizes))]
        denoms = [[(lamx[xoff[i]:xoff[i + 1]][None, None, :]
                    + lamy[yoff[j]:yoff[j + 1]][None, :, None]
                    - rdm2[:, None, None])
                   for j in range(len(ysizes))]
                  for i in range(len(xsizes))]
        return denoms, gxs, gys

    def forward_blocks(self, rhs: jnp.ndarray) -> list:
        """Interior 2-D DST as nested blocks spec[i][j] (x-major);
        concatenating j along -2 then i along -1 reproduces
        forward(rhs)."""
        f = rhs[..., 1:-1, 1:-1]
        return [_dst1_mm_blocks(xb, -2, _HIGHEST)
                for xb in _dst1_mm_blocks(f, -1, _HIGHEST)]

    def inverse_blocks(self, spec: list) -> jnp.ndarray:
        """Inverse of forward_blocks (scaled by norm, zero-padded
        boundary)."""
        cols = [_idst1_mm_blocks(sb, -2, _HIGHEST) for sb in spec]
        sol = _idst1_mm_blocks(cols, -1, _HIGHEST) * self.norm
        nd = sol.ndim
        return jnp.pad(sol, [(0, 0)] * (nd - 2) + [(1, 1), (1, 1)])

    def solve_np(self, rhs: np.ndarray) -> np.ndarray:
        """Host-side float64 solve (model initialisation only)."""
        rhs = np.asarray(rhs, dtype=np.float64)
        interior = rhs[..., 1:-1, 1:-1]
        spec = dst1_np(dst1_np(interior, axis=-1), axis=-2)
        spec = spec * self.denom_inv_np
        sol = dst1_np(dst1_np(spec, axis=-1), axis=-2) * self.norm
        return np.pad(sol, [(0, 0)] * (rhs.ndim - 2) + [(1, 1), (1, 1)])


@dataclass(frozen=True)
class CyclicHelmholtz:
    """Solver for the zonally periodic channel (Dirichlet N/S).

    Grid: p-array of shape (nyp, nxp) where column nxp-1 duplicates
    column 0 (cyclic). The transform works on the nx = nxp-1 distinct
    columns; the output repeats column 0 at the east edge.
    """

    nxp: int
    nyp: int
    lamx: jnp.ndarray        # (nx//2+1,) rfft eigenvalues
    lamy: jnp.ndarray        # (nyp-2,) (packed split order if matmul-y)
    rdm2: jnp.ndarray        # (nm,)
    norm: float
    denom_inv_np: np.ndarray = None   # float64 host copy (init-time solves)
    ytransform: str = "fft"  # y-DST backend: 'fft' | 'matmul'

    def _denom(self):
        # jnp.asarray: see BoxHelmholtz._denom (eager-NumPy trap)
        return (jnp.asarray(self.lamx)[None, None, :]
                + jnp.asarray(self.lamy)[None, :, None]
                - jnp.asarray(self.rdm2)[:, None, None])

    # With ytransform='matmul' the y spectrum is in the radix split's
    # PACKED order (lamy permuted to match at build time); the order is
    # purely internal to solve() -- forward and inverse cancel.
    def _ydst(self, f):
        if self.ytransform == "matmul":
            return _dst1_mm_packed(f, -2, _HIGHEST)
        return dst1(f, axis=-2)

    def _iydst(self, f):
        if self.ytransform == "matmul":
            return _idst1_mm_packed(f, -2, _HIGHEST)
        return dst1(f, axis=-2)

    def solve(self, rhs: jnp.ndarray) -> jnp.ndarray:
        # The x-RFFT and y-DST commute; doing the DST on the REAL field
        # before/after the complex x-transform needs 2 real sine
        # transforms instead of 4 on split real/imag parts (measured
        # ~3x on the 4608x576 southern-ocean channel).
        nx = self.nxp - 1
        interior = rhs[..., 1:-1, :nx]
        sy = self._ydst(interior)
        spec = jnp.fft.rfft(sy, axis=-1)
        spec = spec / self._denom()
        sy = jnp.fft.irfft(spec, n=nx, axis=-1).astype(rhs.dtype)
        sol = self._iydst(sy) * self.norm
        sol = jnp.concatenate([sol, sol[..., :1]], axis=-1)
        return jnp.pad(sol, [(0, 0)] * (rhs.ndim - 2) + [(1, 1), (0, 0)])

    def solve_np(self, rhs: np.ndarray) -> np.ndarray:
        """Host-side float64 solve (model initialisation only)."""
        rhs = np.asarray(rhs, dtype=np.float64)
        nx = self.nxp - 1
        interior = rhs[..., 1:-1, :nx]
        spec = np.fft.rfft(interior, axis=-1)
        spec = dst1_np(spec.real, axis=-2) + 1j * dst1_np(spec.imag, axis=-2)
        spec = spec * self.denom_inv_np
        spec = dst1_np(spec.real, axis=-2) + 1j * dst1_np(spec.imag, axis=-2)
        sol = np.fft.irfft(spec, n=nx, axis=-1) * self.norm
        sol = np.concatenate([sol, sol[..., :1]], axis=-1)
        return np.pad(sol, [(0, 0)] * (rhs.ndim - 2) + [(1, 1), (0, 0)])


def make_box_helmholtz(nxp: int, nyp: int, dx: float, dy: float,
                       rdm2: np.ndarray, dtype=jnp.float64,
                       transform: str = "fft") -> BoxHelmholtz:
    """rdm2: (nm,) vector of 1/Rd^2 values (0 for barotropic).
    transform: one of DST_BACKENDS."""
    nx, ny = nxp - 1, nyp - 1
    k = np.arange(1, nx)                       # x wavenumbers (DST-I)
    l = np.arange(1, ny)                       # y wavenumbers (DST-I)
    lamx = 2.0 / dx**2 * (np.cos(np.pi * k / nx) - 1.0)
    lamy = 2.0 / dy**2 * (np.cos(np.pi * l / ny) - 1.0)
    denom = (lamx[None, None, :] + lamy[None, :, None]
             - np.asarray(rdm2)[:, None, None])
    norm = 1.0 / (2.0 * nx) / (2.0 * ny)
    # DST-I of the ones vector: g[k] = 2 sum_j sin(pi j k/(N+1))
    gx = dst1_np(np.ones((1, nx - 1)))[0]
    gy = dst1_np(np.ones((1, ny - 1)))[0]
    if transform == "matmul":
        # Spectral space is in packed split order on the device: the
        # O(N) vectors follow (denom_inv_np stays natural for the
        # host-side f64 init solves, which use dst1_np).
        px, py = _split_perm(nx - 1), _split_perm(ny - 1)
        lamx, gx = lamx[px], gx[px]
        lamy, gy = lamy[py], gy[py]
    return BoxHelmholtz(nxp=nxp, nyp=nyp,
                        lamx=np.asarray(lamx, dtype=dtype),
                        lamy=np.asarray(lamy, dtype=dtype),
                        rdm2=np.asarray(rdm2, dtype=dtype),
                        gx=np.asarray(gx, dtype=dtype),
                        gy=np.asarray(gy, dtype=dtype),
                        norm=norm, denom_inv_np=1.0 / denom,
                        transform=transform)


def make_cyclic_helmholtz(nxp: int, nyp: int, dx: float, dy: float,
                          rdm2: np.ndarray, dtype=jnp.float64,
                          ytransform: str = "fft") -> CyclicHelmholtz:
    """ytransform: 'fft' | 'matmul' (sine-matrix DST along y; the
    x axis is always RFFT).  With 'matmul' the device-side y spectrum
    stays in packed split order -- lamy is permuted here to match
    (denom_inv_np stays natural for the host-side f64 init solves)."""
    nx, ny = nxp - 1, nyp - 1
    k = np.arange(nx // 2 + 1)                 # rfft wavenumbers
    l = np.arange(1, ny)
    lamx = 2.0 / dx**2 * (np.cos(2.0 * np.pi * k / nx) - 1.0)
    lamy = 2.0 / dy**2 * (np.cos(np.pi * l / ny) - 1.0)
    denom = (lamx[None, None, :] + lamy[None, :, None]
             - np.asarray(rdm2)[:, None, None])
    norm = 1.0 / (2.0 * ny)                    # rfft/irfft self-normalising
    if ytransform == "matmul":
        lamy = lamy[_split_perm(ny - 1)]
    return CyclicHelmholtz(nxp=nxp, nyp=nyp,
                           lamx=np.asarray(lamx, dtype=dtype),
                           lamy=np.asarray(lamy, dtype=dtype),
                           rdm2=np.asarray(rdm2, dtype=dtype),
                           norm=norm, denom_inv_np=1.0 / denom,
                           ytransform=ytransform)
