"""shard_map halo-exchange path (parallel/halo.py): bit-equality with
the GSPMD/XLA vorticity step and pinned collective counts.

The reference's row-parallel OpenMP loops (src/Structure:60-85) map to
explicit ppermute halo exchange over the mesh 'y' axis; these tests
pin both the numerics and the communication schedule XLA emits."""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from qgcm_tpu.config import ModelConfig, OceanConfig
from qgcm_tpu.model import build_model
from qgcm_tpu.models.ocean import (init_ocean_state,
                                   ocean_forcing_from_mean, _oml,
                                   _qgostep, _qgostep_halo)
from qgcm_tpu.models.stepper import make_ocean_only_runner
from qgcm_tpu.generators import eddy_pressure, zero_forcing
from qgcm_tpu.parallel.mesh import shard_tree
from qgcm_tpu.parallel.inspect import collective_stats

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8-device CPU mesh")

VARIANTS = ("staged", "deep", "overlap")


def _setup(cyclic):
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


def _mesh(my):
    devs = np.asarray(jax.devices()[:my]).reshape(my, 1)
    return Mesh(devs, ("y", "x"))


@pytest.mark.parametrize("cyclic", [False, True])
@pytest.mark.parametrize("variant", VARIANTS)
def test_kernel_bit_exact(cyclic, variant):
    """qgstep_halo must reproduce _qgostep's update BIT-exactly: the
    per-point stencil arithmetic is identical, halos only change where
    the neighbour values come from."""
    model, st, f = _setup(cyclic)
    _, _, entoc, *_ = _oml(model, st, f)
    q_ref, _, cyc_ref = _qgostep(model, st, f, entoc)
    q, _, cyc = _qgostep_halo(model, st, f, entoc, _mesh(4), variant)
    assert float(jnp.abs(q_ref - q).max()) == 0.0
    if cyclic:
        for k in cyc_ref:
            np.testing.assert_array_equal(np.asarray(cyc_ref[k]),
                                          np.asarray(cyc[k]), err_msg=k)


@pytest.mark.parametrize("cyclic", [False, True])
def test_runner_matches_gspmd(cyclic):
    """20 steps through the full runner: the halo path must agree with
    the GSPMD path on the SAME mesh to reduction-order tolerance (the
    sharded spectral solve is compiled separately in each program)."""
    model, st, f = _setup(cyclic)
    mesh = _mesh(4)
    st_sh, f_sh = shard_tree(st, mesh), shard_tree(f, mesh)
    ref = make_ocean_only_runner(model, mesh=mesh)(st_sh, f_sh, 20)
    for variant in VARIANTS:
        out = make_ocean_only_runner(model, mesh=mesh,
                                     halo_variant=variant)(
            st_sh, f_sh, 20)
        for name in ("po", "qo", "sst", "dpioc"):
            a = np.asarray(getattr(ref, name))
            b = np.asarray(getattr(out, name))
            scale = np.abs(a).max() + 1e-30
            assert np.abs(a - b).max() < 1e-12 * scale, (variant, name)


def test_collective_counts():
    """The communication schedule is pinned: 'staged' does one
    width-1 exchange per stencil stage (3 rounds x 2 directions),
    'deep'/'overlap' a single width-3 exchange (2 ppermutes), and the
    deep bytes/step are ~9/5 of staged (9 vs 5 rows per direction)."""
    model, st, f = _setup(False)
    _, _, entoc, *_ = _oml(model, st, f)
    mesh = _mesh(8)
    stats = {}
    for variant in VARIANTS:
        fn = jax.jit(functools.partial(_qgostep_halo, model, st, f,
                                       entoc, mesh, variant))
        stats[variant] = collective_stats(fn)
    assert stats["staged"].counts["collective-permute"] == 6
    assert stats["deep"].counts["collective-permute"] == 2
    assert stats["overlap"].counts["collective-permute"] == 2
    b_staged = stats["staged"].bytes_moved["collective-permute"]
    b_deep = stats["deep"].bytes_moved["collective-permute"]
    assert b_deep == pytest.approx(b_staged * 9 / 5, rel=0.05)


MESHES_2D = ((2, 4), (4, 2), (1, 4))


def _mesh2(shape):
    n = shape[0] * shape[1]
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                ("y", "x"))


@pytest.mark.parametrize("shape", MESHES_2D)
@pytest.mark.parametrize("variant", ["deep", "overlap"])
def test_kernel_bit_exact_2d(shape, variant):
    """The 2-D (y,x) decomposition must reproduce _qgostep's update
    BIT-exactly on box configs: ghost columns ride ppermute('x') and
    corners the two-stage y-then-x exchange, but the per-point
    arithmetic is the rows-only path's (parallel/halo._chain2)."""
    model, st, f = _setup(False)
    _, _, entoc, *_ = _oml(model, st, f)
    q_ref, _, _ = _qgostep(model, st, f, entoc)
    q, _, _ = _qgostep_halo(model, st, f, entoc, _mesh2(shape),
                            variant)
    assert float(jnp.abs(q_ref - q).max()) == 0.0


def test_kernel_2d_cyclic_refused():
    """Cyclic channels are rows-only by design (x-sharding the
    duplicated-column wraparound loses; parallel/mesh.make_mesh): the
    2-D halo path must refuse them loudly, not silently mis-wrap."""
    model, st, f = _setup(True)
    _, _, entoc, *_ = _oml(model, st, f)
    with pytest.raises(ValueError, match="rows"):
        _qgostep_halo(model, st, f, entoc, _mesh2((2, 4)), "deep")


def test_runner_matches_gspmd_2d():
    """20 steps through the full runner on a 2-D mesh: the 2-D halo
    path must agree with the GSPMD path on the SAME mesh to
    reduction-order tolerance (the sharded spectral solve is compiled
    separately in each program)."""
    model, st, f = _setup(False)
    mesh = _mesh2((2, 4))
    st_sh, f_sh = shard_tree(st, mesh), shard_tree(f, mesh)
    ref = make_ocean_only_runner(model, mesh=mesh)(st_sh, f_sh, 20)
    for variant in ("deep", "overlap"):
        out = make_ocean_only_runner(model, mesh=mesh,
                                     halo_variant=variant)(
            st_sh, f_sh, 20)
        for name in ("po", "qo", "sst", "dpioc"):
            a = np.asarray(getattr(ref, name))
            b = np.asarray(getattr(out, name))
            scale = np.abs(a).max() + 1e-30
            assert np.abs(a - b).max() < 1e-12 * scale, (variant, name)


def test_collective_counts_2d():
    """2-D schedule pinned: one width-3 row exchange (2 ppermutes)
    plus one width-3 column exchange of the row-extended stack
    (2 ppermutes, corners included) -- 4 per step for both 'deep' and
    'overlap'."""
    model, st, f = _setup(False)
    _, _, entoc, *_ = _oml(model, st, f)
    mesh = _mesh2((2, 4))
    for variant in ("deep", "overlap"):
        fn = jax.jit(functools.partial(_qgostep_halo, model, st, f,
                                       entoc, mesh, variant))
        stats = collective_stats(fn)
        assert stats.counts["collective-permute"] == 4, variant


def test_runner_collectives_reduced():
    """Whole-program communication schedule: replacing GSPMD's
    auto-inserted stencil halos with the explicit width-3 exchange must
    strictly REDUCE the step program's collective-permute count (the
    residual ppermutes belong to the sharded spectral solve and mixed
    layer; measured 117 -> 83 on the box case)."""
    model, st, f = _setup(False)
    mesh = _mesh(8)
    st_sh, f_sh = shard_tree(st, mesh), shard_tree(f, mesh)
    gspmd = collective_stats(
        make_ocean_only_runner(model, mesh=mesh), st_sh, f_sh, 20)
    halo = collective_stats(
        make_ocean_only_runner(model, mesh=mesh,
                               halo_variant="overlap"),
        st_sh, f_sh, 20)
    n_g = gspmd.counts["collective-permute"]
    n_h = halo.counts["collective-permute"]
    assert n_h >= 2                  # the explicit exchange is there
    assert n_h < n_g, (n_h, n_g)     # and it displaced GSPMD's halos
