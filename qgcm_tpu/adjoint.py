"""Adjoint sensitivities: gradients THROUGH the model.

No reference analogue -- Q-GCM has no adjoint (hand-writing one for
the Fortran leapfrog + FFT/Thomas solver would be a separate model).
Here the whole time loop is a pure JAX program, so reverse-mode
`jax.grad` differentiates the complete physics -- leapfrog scan,
Arakawa Jacobian, mixed layers, the spectral PV inversion (matmul-DST
and FFT paths), the channel momentum/mass constraint algebra --
mechanically, to machine precision (pinned against central finite
differences in tests/test_adjoint.py).

The memory problem every adjoint model faces (storing the forward
trajectory for the backward sweep) is handled by rematerialisation:
the runners accept `remat=True` (models/stepper.py), wrapping the scan
body in `jax.checkpoint` so the backward pass stores ONE state carry
per step-pair / coupling cycle and recomputes the step internals --
the standard trade of FLOPs for HBM.

Typical uses: wind-stress sensitivity of channel transport or gyre
energy, initial-condition sensitivity (the tangent-linear
singular-vector machinery behind ensemble perturbations), forcing
inversion by gradient descent.

    sens = ocean_sensitivity(model, layer1_energy_proxy(model))
    val, grads = sens(state0, (tauxo, tauyo, fnetoc), n_steps=1200)
    dL_dtaux = grads.forcing[0]   # (nypo, nxpo) adjoint stress field
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .model import Model
from .state import OceanState


class OceanSensitivity(NamedTuple):
    """Gradients of a scalar objective from ocean_sensitivity."""
    state0: OceanState      # dL/d(initial state), same pytree
    forcing: tuple          # dL/d(tauxo, tauyo, fnetoc)


def ocean_sensitivity(model: Model, loss: Callable[[OceanState],
                                                   jnp.ndarray],
                      remat=True, jit: bool = True, mesh=None,
                      halo_variant=None, segment_steps: int = 0):
    """Build dL/d(initial state, mean forcing) for an ocean-only run.

    loss: scalar function of the FINAL OceanState.
    remat: True = multi-level rematerialised scan (stepper._remat_scan
    -- bounded carries); an int = the per-level fan-out; "dots" = also
    save the spectral GEMM outputs (18% faster backward, more memory);
    False = store the whole forward trajectory (short runs only).
    segment_steps > 0: HOST-LEVEL checkpointing for horizons whose
    in-program backward exceeds device memory: the forward stores one state per segment on the HOST, then one
    per-segment VJP program (compiled once, reused) chains cotangents
    backward exactly -- gradient identical to the single-program
    adjoint at machine precision (test_adjoint), memory bounded by
    one segment. Pick segment_steps so the segment's backward fits
    the card (the limit on an 80 GB card is not measured).
    Returns fn(state0, (tauxo, tauyo, fnetoc), n_steps, step0=0)
    -> (loss_value, OceanSensitivity). n_steps is jit-static.

    The forcing gradient is taken with respect to the physical mean
    fields (the avges.nc triple), THROUGH ocean_forcing_from_mean --
    so dL/dtauxo includes the Ekman-velocity, curl and boundary
    stress-integral (txis/txin) pathways, not just the direct drag
    terms.

    mesh/halo_variant: DISTRIBUTED adjoints -- pass a device mesh
    (and optionally the explicit ppermute halo schedule) and the
    sharded state; XLA transposes the collectives. On a mesh the PV
    inversion runs on the matmul DST: the FFT's rfft transpose fails
    XLA's verifier under GSPMD in float64 (c64 against c128, on CPU
    meshes and on H100s alike). A float64 distributed gradient
    matches the single-device matmul one to ~1e-13 (test_adjoint). The a2a pencil solvers stay forward-only (their
    shard_map cotangents carry mismatched varying-axes annotations),
    so spectral transforms ride GSPMD in adjoint runs."""
    from .model import with_dst
    from .models.ocean import ocean_forcing_from_mean
    from .models.stepper import make_ocean_only_runner
    if mesh is not None:
        model = with_dst(model, "matmul")
    run = make_ocean_only_runner(model, jit=False, remat=remat,
                                 mesh=mesh, halo_variant=halo_variant)

    def objective(state0, mean_forcing, n_steps, step0):
        f = ocean_forcing_from_mean(model, *mean_forcing)
        st = run(state0, f, n_steps, step0)
        return loss(st)

    vg = jax.value_and_grad(objective, argnums=(0, 1))

    def fn(state0, mean_forcing, n_steps: int, step0=0):
        mean_forcing = tuple(jnp.asarray(x) for x in mean_forcing)
        val, (gs, gf) = vg(state0, mean_forcing, n_steps, step0)
        return val, OceanSensitivity(state0=gs, forcing=gf)

    if jit:
        fn = jax.jit(fn, static_argnames=("n_steps",))
    if not segment_steps:
        return fn

    # ---- host-level segment chaining ------------------------------
    # grad of run_N = chained VJPs of run_seg: forward once storing
    # the segment-start states on the host, then walk backward
    # seg-by-seg: cot_in, cot_mf_k = VJP_seg(cot_out); the forcing
    # gradient is the sum over segments (the same mean forcing feeds
    # every step). Exact -- same chain rule the one-program reverse
    # pass applies, just cut at host boundaries.
    fwd_seg = jax.jit(
        lambda s, mf, step0: run(s, ocean_forcing_from_mean(model, *mf),
                                 segment_steps, step0),
        static_argnames=())

    def seg_run(s, mf, nsteps, step0):
        return run(s, ocean_forcing_from_mean(model, *mf), nsteps,
                   step0)

    @jax.jit
    def seg_vjp(s_k, mf, step0, cot):
        # full-segment program: cotangent-in from the segment's final
        # state; returns (cot_state_in, cot_mf_k)
        _, vjp_fn = jax.vjp(
            lambda s, m: seg_run(s, m, segment_steps, step0), s_k, mf)
        return vjp_fn(cot)

    @jax.jit
    def final_seg(s_k, mf, step0):
        # last segment: value + gradients of loss(final state)
        val, (gs, gmf) = jax.value_and_grad(
            lambda s, m: loss(seg_run(s, m, segment_steps, step0)),
            argnums=(0, 1))(s_k, mf)
        return val, gs, gmf

    def fn_seg(state0, mean_forcing, n_steps: int, step0=0):
        if n_steps % segment_steps:
            raise ValueError(
                f"n_steps ({n_steps}) must be a multiple of "
                f"segment_steps ({segment_steps})")
        k_segs = n_steps // segment_steps
        mf = tuple(jnp.asarray(x) for x in mean_forcing)
        import numpy as np
        # forward: store each segment-start state on the HOST (one
        # device->host fetch per segment; K*state would blow HBM)
        starts = [jax.tree.map(np.asarray, state0)]
        st = state0
        for k in range(k_segs - 1):
            st = fwd_seg(st, mf, step0 + k * segment_steps)
            starts.append(jax.tree.map(np.asarray, st))
        # backward sweep
        val, cot, gmf = final_seg(
            starts[-1], mf, step0 + (k_segs - 1) * segment_steps)
        for k in range(k_segs - 2, -1, -1):
            cot, gmf_k = seg_vjp(starts[k], mf,
                                 step0 + k * segment_steps, cot)
            gmf = jax.tree.map(jnp.add, gmf, gmf_k)
        return val, OceanSensitivity(state0=cot, forcing=gmf)

    return fn_seg


def layer1_energy_proxy(model: Model):
    """Scalar objective: domain-mean layer-1 geostrophic kinetic
    energy density (J m^-3 up to the rho factor), computed from the
    final pressure exactly as the analysis layer does
    (u = -p_y/f0, v = p_x/f0):  0.5 * <|grad p|^2> / f0^2."""
    f0 = model.cfg.fnot
    dx = model.grids.dxo

    def loss(st: OceanState):
        p = st.po[0]
        px = (p[:, 1:] - p[:, :-1]) / dx
        py = (p[1:, :] - p[:-1, :]) / dx
        return 0.5 * (jnp.mean(jnp.square(px))
                      + jnp.mean(jnp.square(py))) / f0**2

    return loss


def transport_proxy(model: Model):
    """Scalar objective: zonal-mean zonal transport of layer 1 in a
    channel, <u1> = -<dp/dy>/f0 averaged over the domain -- the ACC
    transport analogue the wind-stress sensitivity is usually asked
    of."""
    f0 = model.cfg.fnot
    dy = model.grids.dxo

    def loss(st: OceanState):
        p = st.po[0]
        return -jnp.mean((p[1:, :] - p[:-1, :]) / dy) / f0

    return loss
