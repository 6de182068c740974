"""Explicit shard_map halo-exchange path for the QG vorticity step.

The reference parallelises every stencil loop over grid rows with
OpenMP (src/Structure:60-85; qgosubs.F loops). The analogue here is
row-block domain decomposition over the mesh 'y' axis with explicit
`lax.ppermute` halo exchange between neighbouring shards -- this module
implements that for the fused vorticity leapfrog chain
(del2 -> del4 -> del6 of the lagged pressure, Arakawa Jacobian, layer
forcing, leapfrog; qgosubs.F:45-229), bit-identical to the XLA/GSPMD
path in models/ocean._qgostep.

Three exchange schedules, selectable for measurement (SURVEY hard
part 6 -- staged width-1 vs single width-3 halos):

  'staged'  -- one width-1 exchange per stencil stage (pom/po/qo
               bundled, then del2p, then del4p): 3 ppermute rounds,
               5 rows sent per direction, no redundant compute.
  'deep'    -- one width-3 exchange of (pom, po, qo) bundled:
               1 ppermute round, 9 rows per direction, each shard
               recomputes the stencil chain within the 3-deep halo.
  'overlap' -- like 'deep', but the chain is evaluated twice: once on
               the local block with zero ghosts (valid everywhere
               except the 3 output rows nearest each shard edge) and
               once on thin 9-row strips built from the exchanged
               halos. The wide interior compute has NO data dependence
               on the ppermutes, so XLA's latency-hiding scheduler
               can run the transfers concurrently with it -- the
               halo exchange can overlap Jacobian/Laplacian compute
               by construction.

Boundary conditions are applied by masking on GLOBAL row indices
(axis_index * block + iota), mirroring ops/stencils.del2_bc.
`lax.ppermute` delivers
ZEROS to shards with no sender, which is precisely the wall
convention, so domain-edge shards need no special-casing. The x axis
stays whole within each shard and is handled per stage with the SAME
shift-copy semantics as ops/stencils (_wshift/_eshift wraparound for
the cyclic duplicated-column convention, zero shifts + masks for the
box) -- recomputing ghost columns instead would break bit-equality
whenever column nxp-1 and column 0 differ in the last ulp.

Decomposition is over 'y' (the faithful analogue of the reference's
row loops) or, for BOX configurations, over both mesh axes: x ghosts
are width-3 column strips exchanged with `lax.ppermute` over the mesh
'x' axis, and diagonal (corner) ghosts ride a two-stage exchange --
rows first, then columns of the row-extended stack, so the x-neighbour
forwards the rows it just received from the diagonal shard. Wall
columns need no special-casing for the same reason wall rows don't:
ppermute delivers ZEROS to shards with no sender, which is the box
convention. CYCLIC channels stay rows-only by design: the duplicated
east p-column's wraparound makes x-sharding lose (full-row gathers
under GSPMD, measured in parallel/mesh.make_mesh), channels are wide
(nx >> ny) so rows are the long axis to split, and `make_mesh` /
`make_hybrid_mesh(rows_only=True)` steer channel runs there.

Row/column counts are padded up to mesh-size multiples outside
shard_map; padded rows/columns are zero on input, every stage masks
them back to zero, and the pad is sliced off on exit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

AXIS = "y"
AXX = "x"


# ----------------------------------------------------------------------
# Exchange primitives
# ----------------------------------------------------------------------

def _exchange(f, h, n_shards):
    """Send this shard's top h rows up and bottom h rows down along the
    mesh 'y' axis. Returns (south_ghost, north_ghost), each
    (..., h, nx); end shards receive zeros (the wall convention)."""
    up = [(i, i + 1) for i in range(n_shards - 1)]
    dn = [(i + 1, i) for i in range(n_shards - 1)]
    south = lax.ppermute(f[..., -h:, :], AXIS, up)
    north = lax.ppermute(f[..., :h, :], AXIS, dn)
    return south, north


def _with_halo(f, h, n_shards):
    """Exchange + assemble y ghosts: (..., R, nx) -> (..., R+2h, nx)."""
    sg, ng = _exchange(f, h, n_shards)
    return jnp.concatenate([sg, f, ng], axis=-2)


def _exchange_x(f, h, n_shards):
    """Send this shard's leftmost/rightmost h COLUMNS along the mesh
    'x' axis. Returns (west_ghost, east_ghost), each (..., R, h); end
    shards receive zeros (box wall convention; cyclic configs never
    take this path)."""
    rt = [(i, i + 1) for i in range(n_shards - 1)]
    lt = [(i + 1, i) for i in range(n_shards - 1)]
    west = lax.ppermute(f[..., -h:], AXX, rt)
    east = lax.ppermute(f[..., :h], AXX, lt)
    return west, east


def _with_halo_x(f, h, n_shards):
    """Exchange + assemble x ghosts: (..., R, C) -> (..., R, C+2h).
    Applied AFTER a y exchange this also fills the corner ghosts: the
    x-neighbour's edge columns include the rows it received from its
    own y-neighbours (the diagonal shards)."""
    wg, eg = _exchange_x(f, h, n_shards)
    return jnp.concatenate([wg, f, eg], axis=-1)


# ----------------------------------------------------------------------
# Globally-indexed stencil stages (mirror ops/stencils)
# ----------------------------------------------------------------------

def _xnbrs(f, cyclic):
    """West/east neighbour columns with the package's exact semantics:
    cyclic p-array wraparound copies (west of column 0 = column nxp-2,
    ops/stencils._wshift/_eshift) or zero shifts for the box."""
    if cyclic:
        w = jnp.concatenate([f[..., -2:-1], f[..., :-1]], axis=-1)
        e = jnp.concatenate([f[..., 1:], f[..., 1:2]], axis=-1)
    else:
        z = jnp.zeros_like(f[..., :1])
        w = jnp.concatenate([z, f[..., :-1]], axis=-1)
        e = jnp.concatenate([f[..., 1:], z], axis=-1)
    return w, e


def _grows(gtop, n):
    """Global row indices, shape (n, 1) for broadcasting over x."""
    return (gtop + jnp.arange(n, dtype=jnp.int32))[:, None]


def _colmasks(nx, dtype_like):
    gc = jnp.arange(nx, dtype=jnp.int32)
    return (gc == 0)[None, :], (gc == nx - 1)[None, :]


def _lap_bc(fp, gtop, ny, nx, bcfac, dxm2, cyclic):
    """Mixed-BC Laplacian of a field with >=1 y-ghost rows; the output
    loses one row each side. `gtop` is the global row index of fp's
    row 0. Rows beyond the true domain (padding) are zeroed."""
    c = fp[..., 1:-1, :]
    s, n = fp[..., :-2, :], fp[..., 2:, :]
    w, e = _xnbrs(c, cyclic)
    lap = dxm2 * (s + n + w + e - 4.0 * c)
    gr = _grows(gtop + 1, c.shape[-2])
    south, north = gr == 0, gr == ny - 1
    out = jnp.where(south, bcfac * (n - c),
                    jnp.where(north, bcfac * (s - c), lap))
    if not cyclic:
        west, east = _colmasks(nx, c)
        zonal = south | north
        out = jnp.where(west & ~zonal, bcfac * (e - c), out)
        out = jnp.where(east & ~zonal, bcfac * (w - c), out)
    return jnp.where(gr > ny - 1, 0.0, out)


def _jacobian(qp, pp, gtop, ny, nx, cyclic):
    """Arakawa 9-point Jacobian sum (x 12 dx dy) from fields with one
    y-ghost row; zonal (and box W/E) boundary outputs zeroed.
    Mirrors ops/stencils.jacobian9 exactly (row zero-pads there =
    ppermute wall zeros here)."""
    def nb(f):
        c, n_, s_ = f[..., 1:-1, :], f[..., 2:, :], f[..., :-2, :]
        w, e = _xnbrs(c, cyclic)
        nw, ne = _xnbrs(n_, cyclic)
        sw, se = _xnbrs(s_, cyclic)
        return e, w, n_, s_, ne, nw, se, sw

    qe, qw, qn, qs, qne, qnw, qse, qsw = nb(qp)
    pe, pw, pn, ps, pne, pnw, pse, psw = nb(pp)
    jac = ((qe - qw) * (pn - ps) + (qs - qn) * (pe - pw)
           + qe * (pne - pse) - qw * (pnw - psw)
           - qn * (pne - pnw) + qs * (pse - psw)
           + pn * (qne - qnw) - ps * (qse - qsw)
           - pe * (qne - qse) + pw * (qnw - qsw))
    gr = _grows(gtop + 1, jac.shape[-2])
    edge = (gr == 0) | (gr >= ny - 1)
    if not cyclic:
        west, east = _colmasks(nx, jac)
        edge = edge | west | east
    return jnp.where(edge, 0.0, jac)


def _assemble(jac, d2c, d4c, d4p1, qo_c, qom, wek, ent, rspl, gtop,
              geom):
    """dqdt assembly + leapfrog + sponge + zonal keep-old mask
    (qgosubs.F:132-229 tail). d4p1 has one y-ghost row (for del6);
    everything else is core-shaped. Returns qnew (core)."""
    (ny, nx, nl, cyclic, sponge, dxm2, bcfac, adfac, rfnot, tdt,
     bdrfac, c1spl, beta_y0, beta_dy, fohfac0, fohfac1, ah2, ah4) = geom

    c = d4p1[..., 1:-1, :]
    w, e = _xnbrs(c, cyclic)
    d6 = dxm2 * (d4p1[..., :-2, :] + d4p1[..., 2:, :] + w + e - 4.0 * c)
    gr = _grows(gtop, d6.shape[-2])
    zonal = (gr == 0) | (gr == ny - 1)
    pad = gr > ny - 1
    edge = zonal
    if not cyclic:
        west, east = _colmasks(nx, d6)
        wecols = west | east
        edge = edge | wecols
    d6 = jnp.where(edge, 0.0, d6)

    fdt = qom.dtype
    ah2v = jnp.asarray(ah2, fdt)[:, None, None]
    ah4v = jnp.asarray(ah4, fdt)[:, None, None]
    dqdt = adfac * jac + (ah2v * rfnot) * d4c - (ah4v * rfnot) * d6
    if not cyclic:
        dqdt = jnp.where(wecols, 0.0, dqdt)

    lhot = jnp.eye(nl, dtype=fdt)[:, :, None, None]
    dqdt = (dqdt + lhot[0] * (fohfac0 * (wek - ent))
            + lhot[1] * (fohfac1 * ent)
            - lhot[nl - 1] * (bdrfac * d2c[nl - 1][None]))

    qnew = qom + tdt * dqdt
    if sponge:
        betay = beta_y0 + beta_dy * gr.astype(fdt)
        qnew = qnew + (tdt * c1spl) * rspl[None] * (qom - betay)
    qnew = jnp.where(zonal, qo_c, qnew)
    return jnp.where(pad, 0.0, qnew)


def _chain(pomp, pop, qop, qom, wek, ent, rspl, gtop3, geom):
    """Full chain from 3-y-ghost-row inputs: pomp/pop/qop are
    (nl, R+6, nx); qom/wek/ent/rspl are core-shaped. gtop3 is the
    global row of pomp's row 0 (= core row 0 minus 3)."""
    (ny, nx, nl, cyclic, *_rest) = geom
    (dxm2, bcfac) = geom[5], geom[6]
    d2 = _lap_bc(pomp, gtop3, ny, nx, bcfac, dxm2, cyclic)
    d4 = _lap_bc(d2, gtop3 + 1, ny, nx, bcfac, dxm2, cyclic)
    jac = _jacobian(qop[..., 2:-2, :], pop[..., 2:-2, :],
                    gtop3 + 2, ny, nx, cyclic)
    return _assemble(jac, d2[..., 2:-2, :], d4[..., 1:-1, :],
                     d4, qop[..., 3:-3, :], qom, wek, ent, rspl,
                     gtop3 + 3, geom)


# ----------------------------------------------------------------------
# 2-D (y,x)-decomposed stages -- BOX configurations only. Same
# arithmetic as the rows-only stages above; the only change is that
# west/east neighbours come from exchanged ghost COLUMNS instead of
# local shifts, and the wall/pad masks key on global column indices.
# ----------------------------------------------------------------------

def _gcols(gleft, n):
    """Global column indices, shape (1, n) for broadcasting over y."""
    return (gleft + jnp.arange(n, dtype=jnp.int32))[None, :]


def _lap_bc2(fp, gtop, gleft, ny, nx, bcfac, dxm2):
    """Mixed-BC box Laplacian of a field with >=1 ghost RINGS; the
    output loses one ring. (gtop, gleft) are the global indices of
    fp's element [0, 0]. Padded rows/columns are zeroed."""
    c = fp[..., 1:-1, 1:-1]
    s, n = fp[..., :-2, 1:-1], fp[..., 2:, 1:-1]
    w, e = fp[..., 1:-1, :-2], fp[..., 1:-1, 2:]
    lap = dxm2 * (s + n + w + e - 4.0 * c)
    gr = _grows(gtop + 1, c.shape[-2])
    gc = _gcols(gleft + 1, c.shape[-1])
    south, north = gr == 0, gr == ny - 1
    west, east = gc == 0, gc == nx - 1
    out = jnp.where(south, bcfac * (n - c),
                    jnp.where(north, bcfac * (s - c), lap))
    zonal = south | north
    out = jnp.where(west & ~zonal, bcfac * (e - c), out)
    out = jnp.where(east & ~zonal, bcfac * (w - c), out)
    return jnp.where((gr > ny - 1) | (gc > nx - 1), 0.0, out)


def _jacobian2(qp, pp, gtop, gleft, ny, nx):
    """Arakawa 9-point Jacobian sum from fields with one ghost ring;
    wall and padded outputs zeroed. Mirrors _jacobian with ring
    neighbours instead of shift-copy x neighbours."""
    def nb(f):
        return (f[..., 1:-1, 2:], f[..., 1:-1, :-2], f[..., 2:, 1:-1],
                f[..., :-2, 1:-1], f[..., 2:, 2:], f[..., 2:, :-2],
                f[..., :-2, 2:], f[..., :-2, :-2])

    qe, qw, qn, qs, qne, qnw, qse, qsw = nb(qp)
    pe, pw, pn, ps, pne, pnw, pse, psw = nb(pp)
    jac = ((qe - qw) * (pn - ps) + (qs - qn) * (pe - pw)
           + qe * (pne - pse) - qw * (pnw - psw)
           - qn * (pne - pnw) + qs * (pse - psw)
           + pn * (qne - qnw) - ps * (qse - qsw)
           - pe * (qne - qse) + pw * (qnw - qsw))
    gr = _grows(gtop + 1, jac.shape[-2])
    gc = _gcols(gleft + 1, jac.shape[-1])
    edge = (gr == 0) | (gr >= ny - 1) | (gc == 0) | (gc >= nx - 1)
    return jnp.where(edge, 0.0, jac)


def _assemble2(jac, d2c, d4c, d4p1, qo_c, qom, wek, ent, rspl, gtop,
               gleft, geom):
    """dqdt assembly + leapfrog + sponge + zonal keep-old mask, box
    2-D-decomposed form. d4p1 has one ghost ring; everything else is
    core-shaped. Returns qnew (core)."""
    (ny, nx, nl, cyclic, sponge, dxm2, bcfac, adfac, rfnot, tdt,
     bdrfac, c1spl, beta_y0, beta_dy, fohfac0, fohfac1, ah2, ah4) = geom

    c = d4p1[..., 1:-1, 1:-1]
    w, e = d4p1[..., 1:-1, :-2], d4p1[..., 1:-1, 2:]
    d6 = dxm2 * (d4p1[..., :-2, 1:-1] + d4p1[..., 2:, 1:-1]
                 + w + e - 4.0 * c)
    gr = _grows(gtop, d6.shape[-2])
    gc = _gcols(gleft, d6.shape[-1])
    zonal = (gr == 0) | (gr == ny - 1)
    pad = (gr > ny - 1) | (gc > nx - 1)
    wecols = (gc == 0) | (gc == nx - 1)
    d6 = jnp.where(zonal | wecols, 0.0, d6)

    fdt = qom.dtype
    ah2v = jnp.asarray(ah2, fdt)[:, None, None]
    ah4v = jnp.asarray(ah4, fdt)[:, None, None]
    dqdt = adfac * jac + (ah2v * rfnot) * d4c - (ah4v * rfnot) * d6
    dqdt = jnp.where(wecols, 0.0, dqdt)

    lhot = jnp.eye(nl, dtype=fdt)[:, :, None, None]
    dqdt = (dqdt + lhot[0] * (fohfac0 * (wek - ent))
            + lhot[1] * (fohfac1 * ent)
            - lhot[nl - 1] * (bdrfac * d2c[nl - 1][None]))

    qnew = qom + tdt * dqdt
    if sponge:
        betay = beta_y0 + beta_dy * gr.astype(fdt)
        qnew = qnew + (tdt * c1spl) * rspl[None] * (qom - betay)
    qnew = jnp.where(zonal, qo_c, qnew)
    return jnp.where(pad, 0.0, qnew)


def _chain2(pomp, pop, qop, qom, wek, ent, rspl, gtop3, gleft3, geom):
    """Full chain from 3-ghost-RING inputs: pomp/pop/qop are
    (nl, R+6, C+6); qom/wek/ent/rspl are core-shaped. (gtop3, gleft3)
    is the global index of pomp's element [0, 0]."""
    (ny, nx, *_rest) = geom
    (dxm2, bcfac) = geom[5], geom[6]
    d2 = _lap_bc2(pomp, gtop3, gleft3, ny, nx, bcfac, dxm2)
    d4 = _lap_bc2(d2, gtop3 + 1, gleft3 + 1, ny, nx, bcfac, dxm2)
    jac = _jacobian2(qop[..., 2:-2, 2:-2], pop[..., 2:-2, 2:-2],
                     gtop3 + 2, gleft3 + 2, ny, nx)
    return _assemble2(jac, d2[..., 2:-2, 2:-2], d4[..., 1:-1, 1:-1],
                      d4, qop[..., 3:-3, 3:-3], qom, wek, ent, rspl,
                      gtop3 + 3, gleft3 + 3, geom)


# ----------------------------------------------------------------------
# shard_map wrapper
# ----------------------------------------------------------------------

def qgstep_halo(pom, po, qo, qom, wekpo, entoc, r_spl, consts, ah2,
                ah4, *, cyclic, sponge, mesh, variant="overlap"):
    """Vorticity leapfrog with explicit ppermute halo exchange over the
    mesh 'y' axis: returns qo_new with zonal rows carrying the OLD qo.
    Bit-identical to models/ocean._qgostep's update.

    Meshes with x > 1 take the 2-D (y,x) decomposition for BOX
    configurations (ghost columns over ppermute('x'), corners via the
    two-stage y-then-x exchange); cyclic channels raise -- they are
    rows-only by design (see module docstring)."""
    (dxm2, bcfac, adfac, rfnot, tdt, bdrfac, c1spl, beta_y0, beta_dy,
     fohfac0, fohfac1) = consts
    nl, ny, nx = pom.shape
    if mesh.shape.get(AXX, 1) > 1:
        if cyclic:
            raise ValueError(
                "the halo path decomposes cyclic channels over rows "
                "only (x-sharding the duplicated-column wraparound "
                "loses; see parallel/mesh.make_mesh) -- use "
                "make_mesh(rows_only=True) / qgcm run --mesh rows")
        return _qgstep_halo_2d(
            pom, po, qo, qom, wekpo, entoc, r_spl, consts, ah2, ah4,
            sponge=sponge, mesh=mesh, variant=variant)
    my = mesh.shape[AXIS]
    ny_pad = -(-ny // my) * my
    by = ny_pad // my
    if variant == "overlap" and by < 6:
        variant = "deep"
    if by < 3:
        # tiny blocks: ghosts would span whole shards; run unsharded
        # semantics
        variant = "local"
    geom = (ny, nx, nl, cyclic, sponge, dxm2, bcfac, adfac, rfnot,
            tdt, bdrfac, c1spl, beta_y0, beta_dy, fohfac0, fohfac1,
            tuple(ah2), tuple(ah4))

    def pad_y(f):
        widths = [(0, 0)] * (f.ndim - 2) + [(0, ny_pad - ny), (0, 0)]
        return jnp.pad(f, widths)

    def local(pom, po, qo, qom, wek, ent, rspl):
        gtop = lax.axis_index(AXIS).astype(jnp.int32) * by
        stack = jnp.concatenate([pom, po, qo], axis=0)

        if variant == "staged":
            sp1 = _with_halo(stack, 1, my)
            pomp1 = sp1[:nl]
            d2 = _lap_bc(pomp1, gtop - 1, ny, nx, bcfac, dxm2, cyclic)
            d2p1 = _with_halo(d2, 1, my)
            d4 = _lap_bc(d2p1, gtop - 1, ny, nx, bcfac, dxm2, cyclic)
            d4p1 = _with_halo(d4, 1, my)
            jac = _jacobian(sp1[2 * nl:], sp1[nl:2 * nl], gtop - 1,
                            ny, nx, cyclic)
            return _assemble(jac, d2, d4, d4p1, qo, qom, wek, ent,
                             rspl, gtop, geom)

        if variant == "deep":
            full = _with_halo(stack, 3, my)
            return _chain(full[:nl], full[nl:2 * nl], full[2 * nl:],
                          qom, wek, ent, rspl, gtop - 3, geom)

        # 'overlap': the wide interior chain consumes only the local
        # block (zero y-ghosts), so it has no data dependence on the
        # ppermutes -- XLA may overlap the transfers with it. The
        # exchanged halos feed only the thin 9-row edge strips.
        sg, ng = _exchange(stack, 3, my)
        z = jnp.zeros_like(stack[..., :3, :])
        full0 = jnp.concatenate([z, stack, z], axis=-2)
        q_int = _chain(full0[:nl], full0[nl:2 * nl], full0[2 * nl:],
                       qom, wek, ent, rspl, gtop - 3, geom)

        def band(parts, core_sl, g0):
            strip = jnp.concatenate(parts, axis=-2)
            return _chain(strip[:nl], strip[nl:2 * nl],
                          strip[2 * nl:], qom[..., core_sl, :],
                          wek[core_sl], ent[core_sl],
                          rspl[core_sl], g0, geom)

        q_s = band([sg, stack[..., :6, :]], slice(0, 3), gtop - 3)
        q_n = band([stack[..., -6:, :], ng], slice(by - 3, by),
                   gtop + by - 6)
        return jnp.concatenate(
            [q_s, q_int[..., 3:-3, :], q_n], axis=-2)

    if variant == "local":
        # single-shard mesh (or tiny blocks): no exchange, zero ghosts
        stack = jnp.concatenate([pad_y(pom), pad_y(po), pad_y(qo)],
                                axis=0)
        z = jnp.zeros_like(stack[..., :3, :])
        full = jnp.concatenate([z, stack, z], axis=-2)
        out = _chain(full[:nl], full[nl:2 * nl], full[2 * nl:],
                     pad_y(qom), pad_y(wekpo), pad_y(entoc),
                     pad_y(r_spl), -3, geom)
        return out[:, :ny]

    spec3 = P(None, AXIS, None)
    spec2 = P(AXIS, None)
    # in_specs name only 'y': on a 2-D mesh this path is reached only
    # via the my>1, mx==1 shape where 'x' carries nothing
    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(spec3, spec3, spec3, spec3, spec2, spec2, spec2),
        out_specs=spec3)
    out = fn(pad_y(pom), pad_y(po), pad_y(qo), pad_y(qom),
             pad_y(wekpo), pad_y(entoc), pad_y(r_spl))
    return out[:, :ny]


def _qgstep_halo_2d(pom, po, qo, qom, wekpo, entoc, r_spl, consts,
                    ah2, ah4, *, sponge, mesh, variant):
    """Box vorticity leapfrog decomposed over BOTH mesh axes: width-3
    row ghosts over ppermute('y'), then width-3 column ghosts of the
    row-extended stack over ppermute('x') (corners ride the second
    stage). Bit-identical to _qgostep / the rows-only path -- the
    per-point arithmetic is the same; only the ghost sourcing changes.

    'deep' recomputes the chain inside the 3-deep ghost frame; 'overlap'
    evaluates the wide interior from the LOCAL block only (no data
    dependence on any ppermute, so XLA may overlap the transfers with
    it) and patches the 3-cell-wide edge frame from four thin band
    windows built out of the exchanged ghosts. 'staged' has no 2-D
    analogue (it exchanges intermediates) and is coerced to 'deep'."""
    nl, ny, nx = pom.shape
    my = mesh.shape.get(AXIS, 1)
    mx = mesh.shape[AXX]
    ny_pad = -(-ny // my) * my
    nx_pad = -(-nx // mx) * mx
    by, bx = ny_pad // my, nx_pad // mx
    if variant == "staged":
        variant = "deep"
    if variant == "overlap" and (by < 6 or bx < 6):
        variant = "deep"
    geom = (ny, nx, nl, False, sponge) + consts + (tuple(ah2),
                                                   tuple(ah4))

    def pad2(f):
        widths = ([(0, 0)] * (f.ndim - 2)
                  + [(0, ny_pad - ny), (0, nx_pad - nx)])
        return jnp.pad(f, widths)

    if by < 3 or bx < 3:
        # tiny blocks: ghosts would span whole shards; run the
        # unsharded chain (GSPMD partitions it) on a zero-ring field
        def ring(f):
            return jnp.pad(f, [(0, 0)] * (f.ndim - 2)
                           + [(3, 3), (3, 3)])
        out = _chain2(ring(pom), ring(po), ring(qo), qom, wekpo,
                      entoc, r_spl, -3, -3, geom)
        return out

    def run_chain(full, qomc, wekc, entc, rsplc, gtop3, gleft3):
        return _chain2(full[:nl], full[nl:2 * nl], full[2 * nl:],
                       qomc, wekc, entc, rsplc, gtop3, gleft3, geom)

    def local(pom, po, qo, qom, wek, ent, rspl):
        gtop = lax.axis_index(AXIS).astype(jnp.int32) * by
        gleft = lax.axis_index(AXX).astype(jnp.int32) * bx
        stack = jnp.concatenate([pom, po, qo], axis=0)

        if variant == "deep":
            full = _with_halo_x(_with_halo(stack, 3, my), 3, mx)
            return run_chain(full, qom, wek, ent, rspl,
                             gtop - 3, gleft - 3)

        # 'overlap': the wide interior chain consumes only the local
        # block (zero ghost rings), so it has no data dependence on
        # either ppermute round; the exchanged frame feeds only the
        # four thin band windows that patch the 3-cell-wide edges.
        sg, ng = _exchange(stack, 3, my)
        ys = jnp.concatenate([sg, stack, ng], axis=-2)  # rows -3..by+3
        wg, eg = _exchange_x(ys, 3, mx)                 # incl. corners

        zy = jnp.zeros_like(stack[..., :3, :])
        zx = jnp.zeros_like(ys[..., :, :3])
        full0 = jnp.concatenate(
            [zx, jnp.concatenate([zy, stack, zy], axis=-2), zx],
            axis=-1)
        q_int = run_chain(full0, qom, wek, ent, rspl,
                          gtop - 3, gleft - 3)

        def band_y(rsl, core_sl, g0):
            strip = jnp.concatenate(
                [wg[..., rsl, :], ys[..., rsl, :], eg[..., rsl, :]],
                axis=-1)
            return run_chain(strip, qom[..., core_sl, :],
                             wek[core_sl], ent[core_sl],
                             rspl[core_sl], g0, gleft - 3)

        def band_x(parts, core_sl, g0x):
            strip = jnp.concatenate(parts, axis=-1)
            return run_chain(strip, qom[..., :, core_sl],
                             wek[:, core_sl], ent[:, core_sl],
                             rspl[:, core_sl], gtop - 3, g0x)

        q_s = band_y(slice(0, 9), slice(0, 3), gtop - 3)
        q_n = band_y(slice(by - 3, by + 6), slice(by - 3, by),
                     gtop + by - 6)
        q_w = band_x([wg, ys[..., :, :6]], slice(0, 3), gleft - 3)
        q_e = band_x([ys[..., :, -6:], eg], slice(bx - 3, bx),
                     gleft + bx - 6)
        mid = jnp.concatenate(
            [q_w[..., 3:by - 3, :], q_int[..., 3:-3, 3:-3],
             q_e[..., 3:by - 3, :]], axis=-1)
        return jnp.concatenate([q_s, mid, q_n], axis=-2)

    spec3 = P(None, AXIS, AXX)
    spec2 = P(AXIS, AXX)
    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(spec3, spec3, spec3, spec3, spec2, spec2, spec2),
        out_specs=spec3)
    out = fn(pad2(pom), pad2(po), pad2(qo), pad2(qom),
             pad2(wekpo), pad2(entoc), pad2(r_spl))
    return out[:, :ny, :nx]
