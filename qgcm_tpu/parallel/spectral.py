"""Explicit all_to_all sharded spectral Helmholtz solves.

The reference parallelises its Helmholtz solvers by OpenMP over rows
for the x-FFT and over wavenumbers for the y-Thomas recursion
(src/ocisubs.F:460-494,565-605) -- the two phases need the data
x-local and y-local respectively.  Under a 2-D device mesh the same
dependency structure appears across chips: the x-transform needs the
full x extent on-device and the y-transform the full y extent.  GSPMD
resolves this by ALL-GATHERING the field (replicating whole grids:
O(N^2) bytes per device); the classic distributed-spectral pattern is
pencil transposes -- `all_to_all` collectives that repartition the
grid so each phase is local, moving only O(N^2 / P) bytes per device.

This module implements that pattern as `shard_map` wrappers around
the single-device solvers in solver/helmholtz.py:

  ShardedBoxHelmholtz      DST-x / DST-y  (finite box, Dirichlet)
  ShardedCyclicHelmholtz   DST-y / RFFT-x (zonally periodic channel)

Box pipeline (mesh ('y','x'), my x mx devices, P = my*mx):

  blocks (By,Bx) --a2a('x')------> x-pencils (By2/mx, mx*Bx)  DST-x
                 --a2a(('y','x'))-> y-pencils (my*By2, Xs/P)   DST-y
  [spectral algebra runs on the y-pencil layout under GSPMD:
   elementwise denominators + O(1) Parseval contractions]
                 <-- exact mirror transposes on the inverse

Four all_to_alls per solve; each transform is applied to a fully-local
axis, so the FFT/matmul kernels are the exact single-device ones
(results match the unsharded solver to ~1e-15 rel; the channel path is
bit-exact).

CEIL-ALIGNED PADDING (the part that makes entry/exit free): shard_map
demands evenly divisible global shapes, but p-grids are N+1 points and
the surrounding step keeps them ceil-sharded.  Padding the grid to an
arbitrary even multiple makes the partitioner RESHARD the uneven
layout -- an all-gather of the full field (at NAtl, (3,4801,4801):
~277 MB/device) before the transposes even ran.
Instead the entry pad target is exactly my*ceil(nyp/my) rows by
mx*ceil(nxp/mx) cols: the even blocks coincide with the ceil shards,
so materialising the pad is LOCAL (only the last shard writes zeros)
and the exit trim is local too.  Every further pad the transposes need
(block -> a2a-divisible block) is applied inside shard_map where it is
free, giving a per-block end-padded ("interleaved") global layout;
the de-interleave/re-interleave are static local slices.  Transform
lengths are always the TRUE extents -- padding never enters a basis.

Chunk-order bookkeeping: a tiled `all_to_all` concatenates received
chunks in GROUP order.  For the box chain the first transpose is over
'x', so the full transpose must use group order ('y','x') for the
per-block pieces to reassemble in block order; the cyclic chain
transposes over 'y' first and therefore uses ('x','y'), and its
y-pencil spectral chunk held by device (iy,ix) is ix*my + iy, which is
what the denominator slice indexes.  tests/test_spectral.py pins both
orderings on 8x1, 4x2, 2x4 and 1x8 meshes.

Spectral layout: the box spectrum is (nm, nyi, Xs) with Xs =
pad_up(nxi, P) -- x padded (sharded axis), y true.  Padded columns
stay exactly zero: their eigenvalue entries are 1.0 and the Parseval
weights gx are 0.0 there, so the constraint algebra in
models/ocean._ocinvq runs unchanged on the padded spectrum.

All wrapper fields are host NumPy (never jax Arrays): these objects
are captured by jitted step closures, and device constants embedded at
lowering would re-fetch and re-compile (see CLAUDE.md / model.py).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P

from ..solver.helmholtz import (
    BoxHelmholtz, CyclicHelmholtz, _HIGHEST, _dst1_mm_packed,
    _idst1_mm_packed, dst1,
)


def _pad_up(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def _ceil_div(n: int, d: int) -> int:
    return -(-n // d)


def _place(f, axis: int, offset: int, target: int):
    """Embed f along `axis` at `offset` in a zero array of extent
    `target` (axis-local pad: (offset, target - offset - n))."""
    n = f.shape[axis]
    widths = [(0, 0)] * f.ndim
    widths[axis % f.ndim] = (offset, target - offset - n)
    return jnp.pad(f, widths)


def _pad_vec(v: np.ndarray, target: int, fill: float) -> np.ndarray:
    out = np.full((target,), fill, dtype=np.asarray(v).dtype)
    out[: len(v)] = v
    return out


def _block_truesizes(n_true: int, nb: int, B: int) -> list[int]:
    """True (unpadded) entries in each of nb ceil-blocks of size B."""
    return [max(0, min(B, n_true - i * B)) for i in range(nb)]


def _sl(f, axis, lo, hi):
    return jax.lax.slice_in_dim(f, lo, hi, axis=axis)


def _drop_block_pads(f, axis: int, nb: int, B2: int, sizes) -> jnp.ndarray:
    """Per-block end-padded layout (nb blocks of B2) -> contiguous true
    entries (sum(sizes)).  Static local slices."""
    parts = [_sl(f, axis, i * B2, i * B2 + sizes[i])
             for i in range(nb) if sizes[i]]
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts,
                                                            axis=axis)


def _insert_block_pads(f, axis: int, nb: int, B2: int, sizes) -> jnp.ndarray:
    """Inverse of _drop_block_pads: contiguous -> nb end-padded blocks."""
    parts, off = [], 0
    for i in range(nb):
        seg = _sl(f, axis, off, off + sizes[i])
        off += sizes[i]
        parts.append(_place(seg, axis, 0, B2))
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts,
                                                            axis=axis)


class ShardedBoxHelmholtz:
    """Drop-in replacement for BoxHelmholtz under a 2-D mesh: same
    attribute surface as used by models/ocean._ocinvq (rdm2, gx, gy,
    norm, _denom, forward/inverse/solve_spec/solve), with the 2-D DST
    routed through explicit all_to_all pencil transposes.  Spectra are
    (nm, nyi, Xs) in the y-pencil layout P(None, None, ('y','x'));
    gx/_denom are padded to Xs to match, so the spectral constraint
    algebra is layout- and padding-oblivious."""

    def __init__(self, base: BoxHelmholtz, mesh):
        self.base = base
        self.mesh = mesh
        self.my = mesh.shape["y"]
        self.mx = mesh.shape["x"]
        self.nprocs = self.my * self.mx
        self.nxp, self.nyp = base.nxp, base.nyp
        self.nxi, self.nyi = base.nxp - 2, base.nyp - 2
        # ceil-aligned entry blocks (see module docstring)
        self.By = _ceil_div(self.nyp, self.my)
        self.Bx = _ceil_div(self.nxp, self.mx)
        self.By2 = _pad_up(self.By, self.mx)      # a2a('x') split needs
        self.Xs = _pad_up(self.nxi, self.nprocs)  # spectral x extent
        self.ysizes = _block_truesizes(self.nyp, self.my, self.By)
        self.transform = base.transform
        self.norm = base.norm
        self.rdm2 = base.rdm2
        # x-side eigenvalues/weights padded to Xs: lam pads with 1.0
        # (denominator stays nonzero: true lam are <= 0 and rdm2 >= 0,
        # so 2.0 - rdm2 cannot vanish for geophysical rdm2 ~ 1e-9);
        # gx pads with 0.0 so Parseval contractions ignore the padding.
        self.lamx = _pad_vec(np.asarray(base.lamx), self.Xs, 1.0)
        self.gx = _pad_vec(np.asarray(base.gx), self.Xs, 0.0)
        self.lamy = np.asarray(base.lamy)         # true nyi
        self.gy = np.asarray(base.gy)

    # -- local transform kernels (full axis on-device) ----------------
    def _tx(self, f, axis):
        if self.transform == "matmul":
            return _dst1_mm_packed(f, axis, _HIGHEST)
        return dst1(f, axis=axis)

    def _itx(self, f, axis):
        if self.transform == "matmul":
            return _idst1_mm_packed(f, axis, _HIGHEST)
        return dst1(f, axis=axis)

    def _denom(self):
        return (jnp.asarray(self.lamx)[None, None, :]
                + jnp.asarray(self.lamy)[None, :, None]
                - jnp.asarray(self.rdm2)[:, None, None])

    # -- distributed transforms ---------------------------------------
    def forward(self, rhs: jnp.ndarray) -> jnp.ndarray:
        """Interior 2-D DST of a p-grid field; returns the spectrum
        (nm, nyi, Xs) in the y-pencil layout P(None, None, ('y','x')),
        x-content at offset 0."""
        nxi, nyi, Xs = self.nxi, self.nyi, self.Xs
        my, mx, By, Bx, By2 = self.my, self.mx, self.By, self.Bx, self.By2
        nyp, ysizes = self.nyp, self.ysizes

        def one(fm):
            # fm: (1, By, Bx) ceil-aligned block of one mode
            fm = _place(fm, -2, 0, By2)
            b = lax.all_to_all(fm, "x", 1, 2, tiled=True)  # x-pencil
            b = _place(self._tx(b[..., 1 : 1 + nxi], -1), -1, 0, Xs)
            c = lax.all_to_all(b, ("y", "x"), 2, 1, tiled=True)
            c = _drop_block_pads(c, -2, my, By2, ysizes)   # (1,nyp,.)
            return self._tx(c[..., 1 : 1 + nyi, :], -2)

        def local(f):
            # one transpose chain PER MODE: each mode's a2a has no
            # dependence on the other modes' transforms, so the
            # latency-hiding scheduler can run mode m+1's all_to_all
            # concurrently with mode m's transform stages (a
            # single monolithic a2a serialises the whole solve behind
            # the transpose).
            return jnp.concatenate(
                [one(f[m : m + 1]) for m in range(f.shape[0])], axis=0)

        fn = jax.shard_map(local, mesh=self.mesh,
                           in_specs=P(None, "y", "x"),
                           out_specs=P(None, None, ("y", "x")))
        # ceil-aligned global pad: blocks coincide with the ceil shards
        # the step already uses, so this pad/the exit trim are LOCAL
        return fn(_place(_place(rhs, -1, 0, mx * Bx), -2, 0, my * By))

    def inverse(self, spec: jnp.ndarray) -> jnp.ndarray:
        """(nm, nyi, Xs) y-pencil spectrum -> p-grid field (zero
        boundary, scaled by norm)."""
        nxi, nyi, Xs = self.nxi, self.nyi, self.Xs
        my, mx, By, Bx, By2 = self.my, self.mx, self.By, self.Bx, self.By2
        nyp, nxp, ysizes = self.nyp, self.nxp, self.ysizes
        norm = self.norm

        def one(sm):
            # sm: (1, nyi, Xs/P) y-pencil of one mode
            c = _place(self._itx(sm, -2), -2, 1, nyp)
            c = _insert_block_pads(c, -2, my, By2, ysizes)
            b = lax.all_to_all(c, ("y", "x"), 1, 2, tiled=True)
            b = _place(norm * self._itx(b[..., :nxi], -1), -1, 1,
                       mx * Bx)
            a = lax.all_to_all(b, "x", 2, 1, tiled=True)
            return a[..., :By, :]                 # drop local y pad

        def local(s):
            # per-mode chains: see forward() -- transposes of one mode
            # overlap the other modes' transform GEMMs
            return jnp.concatenate(
                [one(s[m : m + 1]) for m in range(s.shape[0])], axis=0)

        fn = jax.shard_map(local, mesh=self.mesh,
                           in_specs=P(None, None, ("y", "x")),
                           out_specs=P(None, "y", "x"))
        return fn(spec)[..., : self.nyp, : self.nxp]   # local trim

    def solve_spec(self, rhs: jnp.ndarray) -> jnp.ndarray:
        return self.forward(rhs) / self._denom()

    def solve(self, rhs: jnp.ndarray) -> jnp.ndarray:
        return self.inverse(self.solve_spec(rhs))


class ShardedCyclicHelmholtz:
    """Channel solver with explicit pencil transposes: DST-y on
    y-pencils, RFFT-x + spectral division + IRFFT-x on x-pencils,
    DST-y back.  Used for the cyclic ocean and (always) the
    atmosphere.  Only .solve() is needed by the inversion routines."""

    def __init__(self, base: CyclicHelmholtz, mesh):
        self.base = base
        self.mesh = mesh
        self.my = mesh.shape["y"]
        self.mx = mesh.shape["x"]
        self.nprocs = self.my * self.mx
        self.nxp, self.nyp = base.nxp, base.nyp
        self.nx = base.nxp - 1            # distinct cyclic columns
        self.nyi = base.nyp - 2
        self.By = _ceil_div(self.nyp, self.my)
        self.Bx = _ceil_div(self.nxp, self.mx)
        self.Bx2 = _pad_up(self.Bx, self.my)      # a2a('y') split
        self.Ys = _pad_up(self.nyi, self.nprocs)  # spectral y extent
        self.xsizes = _block_truesizes(self.nxp, self.mx, self.Bx)
        self.norm = base.norm
        self.rdm2 = np.asarray(base.rdm2)
        self.lamx = np.asarray(base.lamx)            # (nx//2+1,) full
        # base.lamy is already in packed split order under matmul-y;
        # the local _ydst emits that same order at offsets 0..nyi-1.
        self.lamy = _pad_vec(np.asarray(base.lamy), self.Ys, 1.0)
        # delegate the y-DST backend dispatch (fft | packed matmul)
        # to the base solver -- one copy of the logic
        self._ydst = base._ydst
        self._iydst = base._iydst

    def solve(self, rhs: jnp.ndarray) -> jnp.ndarray:
        nx, nyi, Ys = self.nx, self.nyi, self.Ys
        my, mx, By, Bx, Bx2 = self.my, self.mx, self.By, self.Bx, self.Bx2
        nyp, nxp, xsizes = self.nyp, self.nxp, self.xsizes
        nP, norm = self.nprocs, self.norm
        Yc = Ys // nP
        dtype = rhs.dtype

        def one(fm, denom_m):
            # fm: (1, By, Bx) block of one mode.  Group order ('x','y')
            # throughout: the first transpose is over 'y' -- see
            # module docstring.
            fm = _place(fm, -1, 0, Bx2)
            b = lax.all_to_all(fm, "y", 2, 1, tiled=True)  # y-pencil
            b = _place(self._ydst(b[..., 1 : 1 + nyi, :]), -2, 0, Ys)
            c = lax.all_to_all(b, ("x", "y"), 1, 2, tiled=True)
            c = _drop_block_pads(c, -1, mx, Bx2, xsizes)   # (.,.,nxp)
            spec = jnp.fft.rfft(c[..., :nx], axis=-1)
            sy = jnp.fft.irfft(spec / denom_m, n=nx,
                               axis=-1).astype(dtype)
            # cyclic duplicate column nxp-1 = column 0, rebuilt here
            # while x is local
            sy = jnp.concatenate([sy, sy[..., :1]], axis=-1)
            sy = _insert_block_pads(sy, -1, mx, Bx2, xsizes)
            d = lax.all_to_all(sy, ("x", "y"), 2, 1, tiled=True)
            d = _place(norm * self._iydst(d[..., :nyi, :]), -2, 1,
                       my * By)
            e = lax.all_to_all(d, "y", 1, 2, tiled=True)
            return e[..., :Bx]                    # drop local x pad

        def local(f):
            r = lax.axis_index("x") * my + lax.axis_index("y")
            lamy_c = lax.dynamic_slice_in_dim(
                jnp.asarray(self.lamy), r * Yc, Yc)
            denom = (jnp.asarray(self.lamx)[None, None, :]
                     + lamy_c[None, :, None]
                     - jnp.asarray(self.rdm2)[:, None, None])
            # per-mode chains: one mode's transposes overlap the other
            # modes' transform work (see ShardedBoxHelmholtz.forward)
            return jnp.concatenate(
                [one(f[m : m + 1], denom[m : m + 1])
                 for m in range(f.shape[0])], axis=0)

        fn = jax.shard_map(local, mesh=self.mesh,
                           in_specs=P(None, "y", "x"),
                           out_specs=P(None, "y", "x"))
        out = fn(_place(_place(rhs, -1, 0, mx * Bx), -2, 0, my * By))
        return out[..., : self.nyp, : self.nxp]        # local trim


def wrap_inversions(model, mesh):
    """Return a Model whose PV-inversion solvers route their global
    transforms through the explicit all_to_all pencil pipeline.  The
    constraint algebra around them is untouched (it is elementwise or
    O(1) reductions, which GSPMD already handles without gathers)."""
    inv_oc, inv_at = model.inv_oc, model.inv_at
    if inv_oc is not None:
        helm = inv_oc.helm
        wrapped = (ShardedCyclicHelmholtz(helm, mesh)
                   if isinstance(helm, CyclicHelmholtz)
                   else ShardedBoxHelmholtz(helm, mesh))
        inv_oc = dataclasses.replace(inv_oc, helm=wrapped)
    if inv_at is not None:
        inv_at = dataclasses.replace(
            inv_at, helm=ShardedCyclicHelmholtz(inv_at.helm, mesh))
    return dataclasses.replace(model, inv_oc=inv_oc, inv_at=inv_at)
