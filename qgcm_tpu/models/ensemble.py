"""Ensemble (perturbed-IC) runs: members as a data-parallel axis.

The reference runs exactly one trajectory per job (one process,
src/cntl_q-gcm:8); predictability/ensemble work with Q-GCM means
re-running the binary per member. Here the ensemble is instead a
first-class batch axis of ONE compiled program: members ride a leading
`vmap` axis through the same jitted leapfrog scan, and on a device
mesh the member axis is sharded so each device steps its own members.
Members never interact, so the compiled step contains ZERO
cross-device collectives (pinned by tests/test_ensemble.py) -- the
framework's analogue of pure data parallelism (SURVEY.md section 2, parallelism table).

Typical use:

    model   = build_model(cfg)
    control = init_ocean_state(model, po=eddy_pressure(cfg))
    members = perturbed_ocean_members(model, control,
                                      jax.random.PRNGKey(0), 8)
    run     = make_ensemble_runner(model, mesh=ensemble_mesh())
    members = run(members, forcing, n_steps=1200)
    sst_spread = ensemble_std(members).sst

Perturbations follow the standard practice for QG predictability
experiments: a smooth, boundary-respecting pressure perturbation is
added to BOTH leapfrog time levels, and PV + constraint scalars are
re-derived from the perturbed pressures exactly as a restart does
(q-gcm.F:715-750) -- each member is an internally consistent state.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..model import Model
from ..state import OceanState, AtmosState
from .ocean import init_ocean_state
from .atmos import init_atmos_state
from .stepper import make_ocean_only_runner, make_coupled_runner


# ----------------------------------------------------------------- #
# member-axis pytree helpers
# ----------------------------------------------------------------- #

def stack_members(states):
    """Stack a list of per-member states into one pytree with a
    leading member axis."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


def member(states, i: int):
    """Extract member i from a stacked ensemble pytree."""
    return jax.tree.map(lambda x: x[i], states)


def n_members(states) -> int:
    return int(jax.tree.leaves(states)[0].shape[0])


def ensemble_mean(states):
    """Member-mean pytree (same structure as a single state)."""
    return jax.tree.map(lambda x: x.mean(axis=0), states)


def ensemble_std(states):
    """Member standard deviation pytree (the ensemble spread)."""
    return jax.tree.map(lambda x: x.std(axis=0), states)


def spread_rms(states, field: str = "po") -> float:
    """Scalar RMS ensemble spread of one state field -- the usual
    predictability-experiment summary curve. (Reduces only the named
    field on device; one scalar comes to the host.)"""
    return float(jnp.sqrt(jnp.mean(
        jnp.square(jnp.std(getattr(states, field), axis=0)))))


# ----------------------------------------------------------------- #
# perturbed initial conditions
# ----------------------------------------------------------------- #

def _smooth_noise(key, shape, n_smooth: int):
    """Unit-RMS Gaussian noise smoothed by n_smooth 5-point passes so
    the perturbation energy sits at resolved scales rather than at the
    grid scale (which the del4 hyperviscosity would remove in a few
    steps)."""
    noise = jax.random.normal(key, shape)
    for _ in range(n_smooth):
        pad = jnp.pad(noise, [(0, 0), (1, 1), (1, 1)], mode="edge")
        noise = 0.2 * (pad[:, 1:-1, 1:-1] + pad[:, :-2, 1:-1]
                       + pad[:, 2:, 1:-1] + pad[:, 1:-1, :-2]
                       + pad[:, 1:-1, 2:])
    return noise / jnp.sqrt(jnp.mean(jnp.square(noise)))


def _boundary_window(cfg):
    """Window that vanishes on solid p-grid boundaries (all four walls
    of a box ocean; only the zonal boundaries of a cyclic channel), so
    the perturbed pressure still satisfies the wall conditions the
    constraint algebra assumes."""
    wy = np.sin(np.pi * np.arange(cfg.nypo) / (cfg.nypo - 1))
    wy[0] = wy[-1] = 0.0          # exact zeros (sin(pi) ~ 1e-16)
    if cfg.cyclic_ocean:
        wx = np.ones(cfg.nxpo)
    else:
        wx = np.sin(np.pi * np.arange(cfg.nxpo) / (cfg.nxpo - 1))
        wx[0] = wx[-1] = 0.0
    return jnp.asarray(np.outer(wy, wx)[None, :, :])


def perturbed_ocean_members(model: Model, base: OceanState, key,
                            m: int, amp: float = 1.0e-3,
                            keep_first: bool = True,
                            n_smooth: int = 4) -> OceanState:
    """Build a stacked m-member ocean ensemble around `base`.

    amp is the RMS pressure perturbation in po units (m^2 s^-2; for
    reference, 1 cm of SSH is ~0.1 m^2 s^-2 at mid-latitude f0). The
    same smooth windowed field is added to po AND pom, then PV and the
    mass/momentum constraint scalars are re-derived per member via
    init_ocean_state -- the same derivation a restart performs. With
    keep_first, member 0 is `base` itself (the control member).

    The model config must carry some dissipation range (nonzero ah4oc
    or bottom drag): the injected noise is broadband, and in a fully
    inviscid setup (the energy-conservation oracle configs) its
    enstrophy cascade piles up at the grid scale with nowhere to go --
    a 60-day inviscid k247 ensemble measured healthy spread saturation
    for ~55 days and then blew up to NaN."""
    keys = jax.random.split(key, m)
    win = _boundary_window(model.cfg)
    members = []
    for i in range(m):
        if i == 0 and keep_first:
            members.append(base)
            continue
        noise = amp * win * _smooth_noise(keys[i], base.po.shape,
                                          n_smooth)
        if model.cfg.cyclic_ocean:
            # p carries a duplicated cyclic column (nxpo = nxto+1);
            # the perturbation must respect the identification or the
            # spectral solve (exactly cyclic by construction) projects
            # it out and q permanently disagrees with qcomp(p)
            noise = noise.at[..., -1].set(noise[..., 0])
        noise = noise.astype(base.po.dtype)
        members.append(init_ocean_state(
            model, po=base.po + noise, pom=base.pom + noise,
            sst=base.sst, sstm=base.sstm))
    return stack_members(members)


def perturbed_atmos_members(model: Model, base: AtmosState, key,
                            m: int, amp: float = 1.0e-2,
                            keep_first: bool = True,
                            n_smooth: int = 4) -> AtmosState:
    """Atmospheric counterpart (channel: perturbation windowed in y
    only). Used for coupled ensembles; amp defaults larger because
    atmospheric pressures are O(10^2) m^2 s^-2."""
    cfg = model.cfg
    keys = jax.random.split(key, m)
    wy = np.sin(np.pi * np.arange(cfg.nypa) / (cfg.nypa - 1))
    wy[0] = wy[-1] = 0.0
    win = jnp.asarray(np.broadcast_to(
        wy[None, :, None], (1, cfg.nypa, 1)))
    members = []
    for i in range(m):
        if i == 0 and keep_first:
            members.append(base)
            continue
        noise = amp * win * _smooth_noise(keys[i], base.pa.shape,
                                          n_smooth)
        # the atmosphere is always zonally cyclic: identify the
        # duplicated column (see the ocean branch above)
        noise = noise.at[..., -1].set(noise[..., 0])
        noise = noise.astype(base.pa.dtype)
        members.append(init_atmos_state(
            model, pa=base.pa + noise, pam=base.pam + noise,
            ast=base.ast, astm=base.astm,
            hmixa=base.hmixa, hmixam=base.hmixam))
    return stack_members(members)


# ----------------------------------------------------------------- #
# ensemble runners
# ----------------------------------------------------------------- #

def ensemble_mesh(devices=None, axis: str = "member") -> Mesh:
    """1-D mesh whose single axis shards the member dimension."""
    devices = list(jax.devices()) if devices is None else list(devices)
    return Mesh(np.array(devices), (axis,))


def shard_members(members, mesh: Mesh):
    """Place a stacked ensemble on a member mesh: each device (and in
    a multi-controller run, each process) stores only its own members'
    shards. Every process must hold the same full host value -- true
    for perturbed_*_members, which are deterministic in the key."""
    ax = mesh.axis_names[0]
    spec = NamedSharding(mesh, P(ax))
    return jax.tree.map(
        lambda x: jax.device_put(jnp.asarray(x), spec), members)


def _check_divisible(members, mesh: Mesh):
    m = n_members(members)
    nd = mesh.devices.size
    if m % nd:
        raise ValueError(
            f"n_members ({m}) must be a multiple of the member-mesh "
            f"device count ({nd})")


def make_ensemble_runner(model: Model, kind: str = None,
                         mesh: Optional[Mesh] = None, jit: bool = True):
    """Vmapped ensemble runner over the standard single-trajectory
    runners (models/stepper.py).

    kind: "ocean" (ocean-only; default when cfg.ocean_only) or
    "coupled". mesh: optional 1-D member mesh from ensemble_mesh();
    the member count must be a multiple of the mesh's device count
    (each device steps an equal block of members). The member axis is
    sharded with `shard_map` -- each device steps its own block of
    members with LOCAL shapes, so the compiled program has no
    collectives at all (GSPMD sharding alone would not: XLA's SPMD
    partitioner replicates FFT ops, all-gathering the member axis at
    every spectral solve). A member x rows composition would add
    halo/a2a traffic per member; whether one member per card on this
    zero-collective mesh beats it, or beats batching several members
    per card, is not measured on the GPU (tools/bench_ensemble_mesh.py).

    Returns run(members, forcing, n_steps, step0=0) for "ocean", or
    run(ocean_members, atmos_members, n_steps, step0=0) for "coupled";
    n_steps is jit-static like the underlying runners."""
    if kind is None:
        kind = "ocean" if model.cfg.ocean_only else "coupled"
    ax = mesh.axis_names[0] if mesh is not None else None
    if kind == "ocean":
        run1 = make_ocean_only_runner(model, jit=False)

        def run(members, forcing, n_steps: int, step0=0):
            def body(ms, f):
                return jax.vmap(
                    lambda s: run1(s, f, n_steps, step0))(ms)
            if mesh is not None:
                _check_divisible(members, mesh)
                body = jax.shard_map(body, mesh=mesh,
                                     in_specs=(P(ax), P()),
                                     out_specs=P(ax))
            return body(members, forcing)
    elif kind == "coupled":
        run1 = make_coupled_runner(model, jit=False)

        def run(oc_members, at_members, n_steps: int, step0=0):
            def body(oms, ams):
                return jax.vmap(
                    lambda o, a: run1(o, a, n_steps, step0))(oms, ams)
            if mesh is not None:
                _check_divisible(oc_members, mesh)
                body = jax.shard_map(body, mesh=mesh,
                                     in_specs=(P(ax), P(ax)),
                                     out_specs=P(ax))
            return body(oc_members, at_members)
    else:
        raise ValueError(f"unknown ensemble kind {kind!r}")

    if jit:
        run = jax.jit(run, static_argnames=("n_steps",))
    return run
