"""Multi-device sharding tests on the 8-virtual-device CPU mesh --
the "fake cluster" test story the reference never had (SURVEY.md
section 4): results must be independent of the sharding layout."""

import numpy as np
import pytest
import jax

from qgcm_tpu.config import ModelConfig, OceanConfig, \
    double_gyre_coupled
from qgcm_tpu.model import build_model
from qgcm_tpu.models.ocean import init_ocean_state, \
    ocean_forcing_from_mean
from qgcm_tpu.models.atmos import init_atmos_state
from qgcm_tpu.models.stepper import (make_ocean_only_runner,
                                     make_coupled_runner)
from qgcm_tpu.generators import eddy_pressure, zero_forcing
from qgcm_tpu.parallel.mesh import make_mesh, shard_tree

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs multi-device CPU mesh")


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


@pytest.mark.parametrize("cyclic", [True, False])
def test_ocean_sharding_equivalence(cyclic):
    """N steps on a 2-D device mesh match the single-device result:
    GSPMD halo exchanges and spectral transposes are exact."""
    model, st, f = _ocean_setup(cyclic)
    ref = make_ocean_only_runner(model)(st, f, 20)

    mesh = make_mesh(jax.devices()[:8])
    st_sh = shard_tree(st, mesh)
    f_sh = shard_tree(f, mesh)
    out = make_ocean_only_runner(model, mesh=mesh)(st_sh, f_sh, 20)

    for name in ("po", "qo", "sst", "dpioc"):
        a = np.asarray(getattr(ref, name))
        b = np.asarray(getattr(out, name))
        scale = np.abs(a).max() + 1e-30
        assert np.abs(a - b).max() < 1e-11 * scale, name


@pytest.mark.parametrize("tau_udiff,rows", [
    (False, False),
    # tau_udiff engages the shard-local pad-embedded windstress and
    # the footprint-window stress recomputation (coupling.py), both
    # of which must reproduce the single-device trajectory -- on the
    # default 2-D mesh AND on the production rows mesh with the a2a
    # spectral solvers + 'overlap' halo schedule
    (True, False),
    (True, True),
])
def test_coupled_sharding_equivalence(tau_udiff, rows):
    cfg = double_gyre_coupled(nxta=24, nyta=12, nxaooc=8, nyaooc=8,
                              ndxr=4, dta=180.0, tau_udiff=tau_udiff,
                              ocean=OceanConfig(dxo=20.0e3))
    model = build_model(cfg)
    # eddy in the ocean so pom is nonzero and the ocean-relative
    # stress (xfosubs.F:150-156,235-300) actually differs from the
    # plain quad-drag path
    oc = init_ocean_state(model, po=eddy_pressure(cfg))
    at = init_atmos_state(model, init="rbal")
    oc_r, at_r = make_coupled_runner(model)(oc, at, 12)

    mesh = make_mesh(jax.devices()[:8], rows_only=rows)
    kwargs = dict(mesh=mesh)
    if rows:
        kwargs.update(spectral_variant="a2a", halo_variant="overlap")
    oc_s = shard_tree(oc, mesh)
    at_s = shard_tree(at, mesh)
    oc_o, at_o = make_coupled_runner(model, **kwargs)(oc_s, at_s, 12)

    for name, a, b in (("po", oc_r.po, oc_o.po),
                       ("pa", at_r.pa, at_o.pa),
                       ("sst", oc_r.sst, oc_o.sst),
                       ("ast", at_r.ast, at_o.ast),
                       ("hmixa", at_r.hmixa, at_o.hmixa)):
        a, b = np.asarray(a), np.asarray(b)
        scale = np.abs(a).max() + 1e-30
        assert np.abs(a - b).max() < 1e-11 * scale, name


def test_hybrid_mesh_groups_hosts_on_y():
    """make_hybrid_mesh puts processes on 'y' and local devices on
    'x' so the spectral a2a('x') stage stays intra-host."""
    from types import SimpleNamespace
    from qgcm_tpu.parallel.mesh import make_hybrid_mesh, \
        _group_by_process

    fakes = [SimpleNamespace(process_index=p, id=p * 4 + i)
             for p in (0, 1) for i in range(4)]
    arr = _group_by_process(fakes)
    assert arr.shape == (2, 4)
    assert [d.process_index for d in arr[:, 0]] == [0, 1]

    with pytest.raises(ValueError):
        _group_by_process(fakes[:5])   # 4 + 1 local devices

    # single-process world: all devices land on 'x' (and on 'y' with
    # rows_only)
    mesh = make_hybrid_mesh(jax.devices()[:8])
    assert dict(mesh.shape) == {"y": 1, "x": 8}
    mesh = make_hybrid_mesh(jax.devices()[:8], rows_only=True)
    assert dict(mesh.shape) == {"y": 8, "x": 1}


def test_sharded_layout_is_distributed():
    """The carried state really is split over devices (not silently
    replicated): each shard's addressable piece is smaller than the
    global array."""
    model, st, f = _ocean_setup(False)
    mesh = make_mesh(jax.devices()[:8])
    st_sh = shard_tree(st, mesh)
    out = make_ocean_only_runner(model, mesh=mesh)(st_sh, f, 2)
    shards = out.sst.addressable_shards
    assert len(shards) == 8
    assert shards[0].data.shape[0] < out.sst.shape[0] or \
        shards[0].data.shape[1] < out.sst.shape[1]
