"""Compiled programs must carry no grid-sized constants.

The solver/model dataclasses store their static arrays as host NumPy
(byte-stable programs, no lowering fetch). The trap: any arithmetic BETWEEN two such fields inside a
traced function runs eagerly in NumPy and bakes the full-size result
into the program as a constant. At NAtl.1km scale that is hundreds of
MB in every executable. These tests trace the production entry points and
assert every closure constant stays O(N) -- they catch the exact
regression that reappeared when bca0698 switched fields to NumPy.
"""

import jax
import jax.numpy as jnp
import numpy as np

from qgcm_tpu.config import ModelConfig
from qgcm_tpu.generators import zero_forcing
from qgcm_tpu.model import build_model
from qgcm_tpu.models import stepper
from qgcm_tpu.models.atmos import init_atmos_state
from qgcm_tpu.models.ocean import init_ocean_state, ocean_forcing_from_mean
from qgcm_tpu.solver.helmholtz import make_box_helmholtz, make_cyclic_helmholtz


def _max_const(closed) -> int:
    return max((np.asarray(c).size for c in closed.consts), default=0)


def test_helmholtz_solve_constants():
    n = 61
    rdm2 = np.array([0.0, 2.3e-9, 8.1e-9])
    rhs = jnp.zeros((3, n + 2, n + 2))
    for tr in ("fft", "matmul"):
        helm = make_box_helmholtz(n + 2, n + 2, 5e3, 5e3, rdm2,
                                  transform=tr)
        assert _max_const(jax.make_jaxpr(helm.solve)(rhs)) <= 4 * n, tr
    cyc = make_cyclic_helmholtz(n + 1, n + 2, 5e3, 5e3, rdm2)
    rhs_c = jnp.zeros((3, n + 2, n + 1))
    assert _max_const(jax.make_jaxpr(cyc.solve)(rhs_c)) <= 4 * n


def _ocean_max_const(n, cyclic):
    cfg = ModelConfig(nxta=n, nyta=n, nxaooc=n, nyaooc=n // 2, ndxr=2,
                      fnot=5.92e-5, beta=2.08e-11,
                      ocean_only=True, cyclic_ocean=cyclic)
    model = build_model(cfg)
    oc = init_ocean_state(model)
    f = ocean_forcing_from_mean(model, *zero_forcing(cfg))
    run = stepper.make_ocean_only_runner(model, jit=False)
    closed = jax.make_jaxpr(lambda s, ff: run(s, ff, 2))(oc, f)
    return cfg, _max_const(closed)


def test_ocean_runner_constants():
    for cyclic in (False, True):
        cfg, mx = _ocean_max_const(48, cyclic)
        # every legitimate constant is an O(N) vector; 8N leaves room
        # for a few stacked vectors without admitting any N^2 field
        assert mx <= 8 * max(cfg.nxpo, cfg.nypo), (cyclic, mx)


def test_coupled_runner_constants():
    cfg = ModelConfig(nxta=32, nyta=32, nxaooc=16, nyaooc=16, ndxr=2,
                      fnot=5.92e-5, beta=2.08e-11)
    model = build_model(cfg)
    oc = init_ocean_state(model)
    at = init_atmos_state(model, init="rbal")
    run = stepper.make_coupled_runner(model, jit=False)
    closed = jax.make_jaxpr(
        lambda o, a: run(o, a, cfg.nstr))(oc, at)
    dims = (cfg.nxpo, cfg.nypo, cfg.nxpa, cfg.nypa, cfg.nxta, cfg.nyta)
    assert _max_const(closed) <= 8 * max(dims)
