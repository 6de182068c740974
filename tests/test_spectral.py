"""Explicit all_to_all sharded spectral solves (parallel/spectral.py).

The analogue of the reference's OpenMP-parallel
FFT-x/Thomas-y Helmholtz phases (src/ocisubs.F:460-494,565-605):
pencil transposes make each transform axis device-local, moving
O(N^2/P) bytes instead of GSPMD's full-grid all-gathers.  Pinned here:
numerical equality with the single-device solvers on every mesh
shape (the chunk-order bookkeeping is shape-dependent), runner-level
trajectory equality, and the collective footprint of the compiled
step (no all-gathers left in the scan body)."""

import re

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from qgcm_tpu.config import ModelConfig, OceanConfig
from qgcm_tpu.model import build_model
from qgcm_tpu.models.ocean import init_ocean_state, \
    ocean_forcing_from_mean
from qgcm_tpu.models.stepper import make_ocean_only_runner
from qgcm_tpu.generators import eddy_pressure, zero_forcing
from qgcm_tpu.parallel.mesh import make_mesh, shard_tree
from qgcm_tpu.parallel.spectral import (ShardedBoxHelmholtz,
                                        ShardedCyclicHelmholtz)
from qgcm_tpu.parallel.inspect import collective_stats
from qgcm_tpu.solver.helmholtz import (make_box_helmholtz,
                                       make_cyclic_helmholtz)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8-device CPU mesh")

MESH_SHAPES = [(4, 2), (2, 4), (8, 1), (1, 8)]
RDM2 = np.array([0.0, 2.3, 7.7])


def _mesh(shape):
    return Mesh(np.asarray(jax.devices()[:8]).reshape(shape),
                ("y", "x"))


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_box_solve_matches_single_device(shape):
    """Every mesh shape exercises different chunk-order bookkeeping
    (group order of the tiled all_to_alls)."""
    rng = np.random.default_rng(0)
    base = make_box_helmholtz(19, 15, 0.7, 0.9, RDM2)
    sh = ShardedBoxHelmholtz(base, _mesh(shape))
    rhs = jnp.asarray(rng.standard_normal((3, 15, 19)))
    a = np.asarray(base.solve(rhs))
    b = np.asarray(jax.jit(sh.solve)(rhs))
    assert np.abs(a - b).max() < 1e-13 * np.abs(a).max()


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_cyclic_solve_matches_single_device(shape):
    rng = np.random.default_rng(1)
    base = make_cyclic_helmholtz(17, 15, 0.7, 0.9, RDM2)
    sh = ShardedCyclicHelmholtz(base, _mesh(shape))
    rhs = jnp.asarray(rng.standard_normal((3, 15, 17)))
    rhs = rhs.at[..., -1].set(rhs[..., 0])     # cyclic duplicate col
    a = np.asarray(base.solve(rhs))
    b = np.asarray(jax.jit(sh.solve)(rhs))
    # same local FFT kernels in the same order: bit-exact
    assert np.abs(a - b).max() < 1e-14 * np.abs(a).max()


@pytest.mark.parametrize("shape", [(4, 2), (1, 8)])
def test_box_solve_matmul_transform_sharded(shape):
    """The matmul (packed split-order) transform also rides the
    pencil pipeline (distributed float64 adjoints need it). Forced
    here at small size on the CPU mesh: the permuted
    eigenvalue/weight vectors must stay consistent with the packed
    spectra across the transposes."""
    rng = np.random.default_rng(4)
    base = make_box_helmholtz(21, 17, 0.7, 0.9, RDM2,
                              transform="matmul")
    sh = ShardedBoxHelmholtz(base, _mesh(shape))
    rhs = jnp.asarray(rng.standard_normal((3, 17, 21)))
    a = np.asarray(base.solve(rhs))
    b = np.asarray(jax.jit(sh.solve)(rhs))
    assert np.abs(a - b).max() < 1e-12 * np.abs(a).max()


def test_box_spectrum_padding_is_inert():
    """solve_spec returns the PADDED spectrum; padded entries are
    exactly zero and the padded Parseval weights reproduce the
    unsharded contraction (what _ocinvq's constraint algebra needs)."""
    rng = np.random.default_rng(2)
    base = make_box_helmholtz(19, 15, 0.7, 0.9, RDM2)
    sh = ShardedBoxHelmholtz(base, _mesh((4, 2)))
    rhs = jnp.asarray(rng.standard_normal((3, 15, 19)))
    spec = np.asarray(jax.jit(sh.solve_spec)(rhs))
    assert spec.shape == (3, sh.nyi, sh.Xs)
    assert np.all(spec[:, :, sh.nxi:] == 0.0)
    ref = np.asarray(base.solve_spec(rhs))
    got = np.einsum("myx,y,x->m", spec, sh.gy, sh.gx)
    want = np.einsum("myx,y,x->m", ref, np.asarray(base.gy),
                     np.asarray(base.gx))
    assert np.abs(got - want).max() < 1e-12 * (np.abs(want).max() + 1e-30)


def _ocean_setup(cyclic):
    cfg = ModelConfig(nxta=24, nyta=24, nxaooc=24, nyaooc=12, ndxr=2,
                      fnot=5.92e-5, beta=2.08e-11,
                      ocean=OceanConfig(nlo=2, dxo=20e3, delek=2.0,
                                        hoc=(800.0, 3200.0),
                                        gpoc=(0.01,),
                                        tabsoc=(287.0, 282.0),
                                        ah2oc=(0.0, 0.0),
                                        ah4oc=(1e10, 1e10)),
                      ocean_only=True, cyclic_ocean=cyclic).validate()
    model = build_model(cfg)
    st = init_ocean_state(model, po=eddy_pressure(cfg))
    f = ocean_forcing_from_mean(model, *zero_forcing(cfg))
    return model, st, f


@pytest.mark.parametrize("cyclic", [False, True])
def test_runner_a2a_equivalence(cyclic):
    """Trajectories through the a2a spectral path match the
    single-device run (rows-only mesh for the channel: make_mesh
    docstring)."""
    model, st, f = _ocean_setup(cyclic)
    ref = make_ocean_only_runner(model)(st, f, 20)
    mesh = make_mesh(jax.devices()[:8], rows_only=cyclic)
    st_sh = shard_tree(st, mesh)
    f_sh = shard_tree(f, mesh)
    out = make_ocean_only_runner(model, mesh=mesh,
                                 spectral_variant="a2a")(st_sh, f_sh, 20)
    for name in ("po", "qo", "sst", "dpioc"):
        a = np.asarray(getattr(ref, name))
        b = np.asarray(getattr(out, name))
        scale = np.abs(a).max() + 1e-30
        assert np.abs(a - b).max() < 1e-12 * scale, name


def _loop_body(run, *args):
    txt = run.lower(*args).compile().as_text()
    return max(re.split(r"\n(?=%|ENTRY)", txt), key=len)


def _loop_body_collectives(run, *args):
    body = _loop_body(run, *args)
    return {op: len(re.findall(" " + op, body))
            for op in ("all-gather", "all-to-all", "collective-permute")}


def _gather_bytes(body):
    """Output bytes of every all-gather instruction in an HLO body."""
    from qgcm_tpu.parallel.inspect import _shape_bytes
    out = []
    for line in body.splitlines():
        s = line.strip()
        if re.search(r"=\s+\S*\s*all-gather(-start)?\(", s):
            out.append(_shape_bytes(s))
    return out


@pytest.mark.parametrize("cyclic", [False, True])
def test_a2a_step_has_no_loop_body_gathers(cyclic):
    """The north-star communication property: with explicit pencil
    transposes the compiled scan body contains NO all-gather -- every
    collective is a halo permute or an O(N^2/P) transpose.  The GSPMD
    spectral solve gathers full grids every step (12 gathers/iteration
    for the box at this size)."""
    model, st, f = _ocean_setup(cyclic)
    mesh = make_mesh(jax.devices()[:8], rows_only=cyclic)
    st_sh = shard_tree(st, mesh)
    f_sh = shard_tree(f, mesh)
    run = make_ocean_only_runner(model, mesh=mesh,
                                 spectral_variant="a2a")
    counts = _loop_body_collectives(run, st_sh, f_sh, 20)
    assert counts["all-gather"] == 0, counts
    assert counts["all-to-all"] > 0, counts
    gspmd = make_ocean_only_runner(model, mesh=mesh)
    base = _loop_body_collectives(gspmd, st_sh, f_sh, 20)
    assert base["all-gather"] > 0, base


@pytest.mark.parametrize("tau_udiff", [False, True])
def test_coupled_a2a_no_field_sized_gathers(tau_udiff):
    """The coupled cycle's collective footprint: with the mesh-aware
    xforc (coupling.make_xforc) every all-gather in the compiled scan
    body is bounded by the COARSE atmospheric grid -- the ocean/fine
    grids (ndxr^2 = 16x bigger here, 256-1600x at production) never
    ride a gather. The round-2 layout gathered ocean-window-sized
    operands every cycle (the xforc footprint embedding), which caps
    multi-chip scaling of the flagship coupled configuration.
    tau_udiff=True additionally pins the ocean-relative windstress
    scatter (a static-offset pad, point-to-point under GSPMD -- the
    .at[].add form gathered the ocean-sized difference 4x/cycle)."""
    from qgcm_tpu.config import double_gyre_coupled, OceanConfig
    from qgcm_tpu.models.atmos import init_atmos_state
    from qgcm_tpu.models.stepper import make_coupled_runner
    cfg = double_gyre_coupled(nxta=16, nyta=16, nxaooc=12, nyaooc=12,
                              ndxr=4, dta=180.0, tau_udiff=tau_udiff,
                              ocean=OceanConfig(dxo=20.0e3)).validate()
    model = build_model(cfg)
    mesh = make_mesh(jax.devices()[:8], rows_only=True)
    ocean = shard_tree(init_ocean_state(model, init="rbal"), mesh)
    atmos = shard_tree(init_atmos_state(model, init="rbal"), mesh)
    run = make_coupled_runner(model, mesh=mesh, spectral_variant="a2a")
    body = _loop_body(run, ocean, atmos, 2 * cfg.nstr)
    sizes = _gather_bytes(body)
    # bound: the ceil-padded coarse atmos p grid (largest replicated
    # coarse operand); ocean/fine fields are ndxr^2 bigger
    pad_y = -(-(cfg.nypa) // 8) * 8
    atmos_bytes = 8 * pad_y * cfg.nxpa
    ocean_bytes = 8 * cfg.nypo * cfg.nxpo
    assert atmos_bytes * 2 < ocean_bytes          # scale separation
    assert sizes, "expected the small coarse-input gathers"
    assert max(sizes) <= atmos_bytes, (sorted(sizes), atmos_bytes)
    counts = {op: len(re.findall(" " + op, body))
              for op in ("all-to-all",)}
    assert counts["all-to-all"] > 0


def test_box_a2a_realistic_uneven_shape():
    """Ceil-alignment stress at a NAtl-like aspect: 577x577x3 box
    p-grid (uneven over every mesh axis) through the a2a runner on a
    2-D mesh -- the regression mode this machinery was built against
    (a silently dropped uneven sharding turned the solve entry into a
    full-grid all-gather at 4801^2). Census + short-trajectory
    equality vs the single-device run."""
    cfg = ModelConfig(nxta=96, nyta=96, nxaooc=72, nyaooc=72, ndxr=8,
                      fnot=9.4e-5, beta=1.75e-11,
                      ocean=OceanConfig(nlo=3, dxo=5e3),
                      ocean_only=True, cyclic_ocean=False).validate()
    assert cfg.nxpo == 577 and cfg.nypo == 577
    model = build_model(cfg)
    st = init_ocean_state(model, po=eddy_pressure(cfg))
    f = ocean_forcing_from_mean(model, *zero_forcing(cfg))
    mesh = make_mesh(jax.devices()[:8])          # (4, 2): 577 uneven
    st_sh, f_sh = shard_tree(st, mesh), shard_tree(f, mesh)
    run = make_ocean_only_runner(model, mesh=mesh,
                                 spectral_variant="a2a")
    counts = _loop_body_collectives(run, st_sh, f_sh, 4)
    assert counts["all-gather"] == 0, counts
    out = run(st_sh, f_sh, 4)
    ref = make_ocean_only_runner(model)(st, f, 4)
    for name in ("po", "qo"):
        a = np.asarray(getattr(ref, name))
        b = np.asarray(getattr(out, name))
        scale = np.abs(a).max() + 1e-30
        assert np.abs(a - b).max() < 1e-11 * scale, name


def test_cyclic_a2a_realistic_uneven_shape():
    """Channel analogue: 1153x145x3 (southern-ocean aspect, x >> y)
    on the rows-only mesh; zero all-gathers and trajectory equality."""
    cfg = ModelConfig(nxta=144, nyta=48, nxaooc=144, nyaooc=18, ndxr=8,
                      fnot=-1.19e-4, beta=1.31e-11,
                      ocean=OceanConfig(nlo=3, dxo=5e3),
                      ocean_only=True, cyclic_ocean=True).validate()
    assert cfg.nxpo == 1153 and cfg.nypo == 145
    model = build_model(cfg)
    st = init_ocean_state(model, po=eddy_pressure(cfg))
    f = ocean_forcing_from_mean(model, *zero_forcing(cfg))
    mesh = make_mesh(jax.devices()[:8], rows_only=True)  # 145 uneven
    st_sh, f_sh = shard_tree(st, mesh), shard_tree(f, mesh)
    run = make_ocean_only_runner(model, mesh=mesh,
                                 spectral_variant="a2a")
    counts = _loop_body_collectives(run, st_sh, f_sh, 4)
    assert counts["all-gather"] == 0, counts
    out = run(st_sh, f_sh, 4)
    ref = make_ocean_only_runner(model)(st, f, 4)
    for name in ("po", "qo"):
        a = np.asarray(getattr(ref, name))
        b = np.asarray(getattr(out, name))
        scale = np.abs(a).max() + 1e-30
        assert np.abs(a - b).max() < 1e-11 * scale, name


def test_solve_moves_fewer_bytes_than_gspmd():
    """Per-solve traffic: the pencil path must move strictly less than
    the GSPMD lowering (measured ~6.5x less at this size)."""
    rng = np.random.default_rng(3)
    mesh = _mesh((4, 2))
    base = make_box_helmholtz(99, 67, 0.7, 0.9, RDM2)
    sh = ShardedBoxHelmholtz(base, mesh)
    rhs = jnp.asarray(rng.standard_normal((3, 67, 99)))
    sharding = NamedSharding(mesh, P(None, "y", "x"))

    def gspmd(r):
        r = jax.lax.with_sharding_constraint(r, sharding)
        return jax.lax.with_sharding_constraint(base.solve(r), sharding)

    def a2a(r):
        r = jax.lax.with_sharding_constraint(r, sharding)
        return jax.lax.with_sharding_constraint(sh.solve(r), sharding)

    b_gspmd = sum(collective_stats(gspmd, rhs).bytes_moved.values())
    b_a2a = sum(collective_stats(a2a, rhs).bytes_moved.values())
    assert b_a2a < 0.5 * b_gspmd, (b_a2a, b_gspmd)


@pytest.mark.parametrize("shape", [(4, 2), (1, 8)])
def test_cyclic_solve_matmul_y_sharded(shape, monkeypatch):
    """ytransform='matmul' (packed split-order y spectra, permuted
    lamy) must survive the pencil transposes: the per-chunk lamy slice
    indexes the PERMUTED vector, which only works if the local packed
    DST emits exactly the order the build-time permutation assumed.
    _MM_SPLIT_MIN is forced low so recursion levels are exercised."""
    import qgcm_tpu.solver.helmholtz as H
    monkeypatch.setattr(H, "_MM_SPLIT_MIN", 4)
    rng = np.random.default_rng(9)
    # nyp=35 -> y interior 33 (ODD): the packed radix split actually
    # recurses, so the permuted-lamy/packed-order alignment is really
    # exercised (an even interior degenerates to the plain sine GEMM
    # with an identity permutation and would pin nothing)
    base = make_cyclic_helmholtz(17, 35, 0.7, 0.9, RDM2,
                                 ytransform="matmul")
    assert len(H._split_sizes(33)) > 1
    sh = ShardedCyclicHelmholtz(base, _mesh(shape))
    rhs = jnp.asarray(rng.standard_normal((3, 35, 17)))
    rhs = rhs.at[..., -1].set(rhs[..., 0])     # cyclic duplicate col
    a = np.asarray(base.solve(rhs))
    b = np.asarray(jax.jit(sh.solve)(rhs))
    assert np.abs(a - b).max() < 1e-12 * np.abs(a).max()
