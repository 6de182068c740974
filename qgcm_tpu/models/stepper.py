"""Time-stepping drivers.

The reference main loop (src/q-gcm.F:1220-1491) interleaves physics,
cadenced diagnostics and I/O in one Fortran DO loop. Here the physics
is a pure `lax.scan` (compiled once, runs entirely on device); I/O and
diagnostics cadences are handled by the host driver slicing the run
into chunks (see qgcm_tpu/run.py).

Leapfrog computational-mode suppression (q-gcm.F:1325-1366): the
current time level is averaged with the lagged one, x <- (x+xm)/2,
after ocean substep n for (n-1) % 25 == 0 (and every 100 atmos steps
for the atmosphere). NOT a Robert-Asselin filter -- the lagged level
is left unchanged, exactly as the reference does.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from ..model import Model
from ..state import OceanState, OceanForcing, AtmosState, AtmosForcing
from .ocean import make_ocean_step
from .atmos import make_atmos_step

OCEAN_AVG_PERIOD = 25   # ocean substeps between time-level averagings
ATMOS_AVG_PERIOD = 100  # atmos steps between averagings


def _remat_wrap(body, remat):
    """jax.checkpoint wrapper for the scan bodies (reverse-mode
    memory control, adjoint.py). remat truthy: rematerialise the
    body -- the backward pass stores only the per-iteration carry,
    not the step internals. remat="dots": additionally save dot
    outputs (the matmul spectral-solve GEMMs) at the cost of retaining
    grid-sized GEMM results per step -- for short-horizon
    sensitivities; True for long ones."""
    if not remat:
        return body
    if remat == "dots":
        return jax.checkpoint(
            body, policy=jax.checkpoint_policies.dots_saveable)
    return jax.checkpoint(body)


# Per-iteration carry checkpointing alone is O(n) carries on the
# backward pass -- 2400 saved production-channel states would need
# ~105 GB. Nested checkpointed scans bound it at O(levels * LEVEL)
# carries (the classic multi-level/treeverse trade: one extra forward
# recompute per nesting level). LEVEL=16 keeps the 30-day
# production-channel adjoint around ~40 saved carries (~6 GB at the
# southern state size).
REMAT_LEVEL = 16


def _remat_scan(body, carry, length, remat, level=None):
    """lax.scan(body) over `length` iterations with multi-level
    rematerialisation when `remat` is set. The per-level fan-out is
    LEVEL (= `remat` when it is an int >= 2): a run of N iterations
    nests ceil(log_LEVEL N) checkpointed scan levels, so reverse-mode
    stores at most ~levels*LEVEL carries while each level's backward
    recomputes its chunk forward once. body: (carry, None) ->
    (carry, None)."""
    if not remat:
        carry, _ = jax.lax.scan(body, carry, None, length=length)
        return carry
    if level is None:
        level = remat if isinstance(remat, int) \
            and not isinstance(remat, bool) and remat >= 2 \
            else REMAT_LEVEL
    body = _remat_wrap(body, remat)

    def run(fn, carry, n):
        # fn is the current level's unit (the leaf body, or a
        # checkpointed chunk of the level below)
        if n <= level:
            carry, _ = jax.lax.scan(fn, carry, None, length=n)
            return carry
        chunks, rem = divmod(n, level)

        def chunk(c, _):
            c2, _ = jax.lax.scan(fn, c, None, length=level)
            return c2, None

        carry = run(jax.checkpoint(chunk), carry, chunks)
        if rem:
            carry, _ = jax.lax.scan(fn, carry, None, length=rem)
        return carry

    return run(body, carry, length)


def average_ocean_levels(st: OceanState) -> OceanState:
    """x <- (x + xm)/2 for the current time level only
    (q-gcm.F:1328-1366 including the constraint variables)."""
    return st._replace(
        po=0.5 * (st.po + st.pom),
        qo=0.5 * (st.qo + st.qom),
        sst=0.5 * (st.sst + st.sstm),
        dpioc=0.5 * (st.dpioc + st.dpiocp),
        ocncs=0.5 * (st.ocncs + st.ocncsp),
        ocncn=0.5 * (st.ocncn + st.ocncnp),
    )


def average_atmos_levels(st: AtmosState) -> AtmosState:
    """Atmospheric analogue (q-gcm.F:1370-1407)."""
    return st._replace(
        pa=0.5 * (st.pa + st.pam),
        qa=0.5 * (st.qa + st.qam),
        ast=0.5 * (st.ast + st.astm),
        hmixa=0.5 * (st.hmixa + st.hmixam),
        dpiat=0.5 * (st.dpiat + st.dpiatp),
        atmcs=0.5 * (st.atmcs + st.atmcsp),
        atmcn=0.5 * (st.atmcn + st.atmcnp),
    )


def make_ocean_only_runner(model: Model, jit: bool = True, mesh=None,
                           halo_variant=None, spectral_variant=None,
                           remat: bool = False):
    """Returns run(state, forcing, n_steps, step0=0) -> (state, diags).

    `step0` is the 0-based index of the first ocean substep taken by
    this call, so chunked host loops keep the averaging cadence
    aligned (averaging fires after substeps with index % 25 == 0).

    With `mesh`, fields carry 2-D spatial shardings through the scan
    (GSPMD inserts the halo exchanges and spectral-solve transposes
    over the mesh; see parallel/mesh.py). `halo_variant` additionally
    routes the vorticity stencil chain through the explicit shard_map
    ppermute halo-exchange path ('staged' | 'deep' | 'overlap',
    parallel/halo.py). `spectral_variant='a2a'` routes the PV-inversion
    transforms through explicit all_to_all pencil transposes instead of
    GSPMD's gathers (parallel/spectral.py).

    remat=True wraps the scan body in jax.checkpoint so reverse-mode
    differentiation (adjoint.py) stores only the per-iteration carry
    and recomputes the step's internals (stencil chains, spectral
    solve stages) on the backward pass -- the standard trade of
    FLOPs for device memory. remat="dots" additionally saves the GEMM
    outputs (more memory; _remat_wrap).
    Forward-only runs are unaffected (primal computation is
    identical); leave it False unless differentiating.
    """
    halo = (mesh, halo_variant) if (mesh is not None
                                    and halo_variant) else None
    if mesh is not None and spectral_variant == "a2a":
        from ..parallel.spectral import wrap_inversions
        model = wrap_inversions(model, mesh)
    step = make_ocean_step(model, halo=halo)
    if mesh is not None:
        from ..parallel.mesh import constrain_tree

    def run(state: OceanState, forcing: OceanForcing, n_steps: int,
            step0=0):
        def one(st, n):
            st, _diags = step(st, forcing)
            return jax.lax.cond(n % OCEAN_AVG_PERIOD == 0,
                                average_ocean_levels, lambda s: s, st)

        # Two substeps per scan iteration: after one leapfrog substep
        # the old time level moves carry slot (pom <- po), which XLA's
        # fixed while-loop buffers can only express as full-field
        # copies (~10 ms/step at NAtl scale). After TWO substeps every
        # slot holds a freshly computed value, so the pair-body carries
        # no slot-permutation copies.
        def body(carry, _):
            st, n = carry
            if mesh is not None:
                st = constrain_tree(st, mesh)
            st = one(one(st, n), n + 1)
            return (st, n + 2), None

        pairs, rem = divmod(n_steps, 2)
        state, n = _remat_scan(body, (state, jnp.asarray(step0)),
                               pairs, remat)
        if rem:
            if mesh is not None:
                state = constrain_tree(state, mesh)
            state = one(state, n)
        return state

    if jit:
        run = jax.jit(run, static_argnames=("n_steps",))
    return run


def _split_cycles(n_steps: int, nstr: int):
    """Validate chunk alignment for the cycle-structured runners: the
    loop advances in whole coupling cycles (the Driver aligns all its
    cadences and chunks to nstr). step0 alignment is checked at trace
    time by the callers where it is static."""
    if n_steps % nstr:
        raise ValueError(
            f"n_steps ({n_steps}) must be a multiple of nstr ({nstr}) "
            "for the cycle-structured coupled/atmos-only runners")
    return n_steps // nstr


def make_atmos_only_runner(model: Model, jit: bool = True):
    """Atmosphere-only mode: the ocean surface is a prescribed mean SST
    field (reference q-gcm.F:752-826 reads it from avges.nc). xforc is
    re-evaluated every step-cadence nstr exactly as when coupled.

    Returns run(state, sst_mean, n_steps, step0=0) -> state.
    n_steps must be a multiple of nstr: the time loop is structured as
    coupling CYCLES (forcing refresh + nstr atmos steps) rather than
    per-step `lax.cond` dispatch around the forcing computation.
    """
    from ..coupling import make_xforc
    xforc = make_xforc(model)
    step = make_atmos_step(model)
    nstr = model.cfg.nstr

    def run(state: AtmosState, sst_mean, n_steps: int, step0=0):
        n_cycles = _split_cycles(n_steps, nstr)
        if isinstance(step0, int) and step0 % nstr:
            raise ValueError(f"step0 ({step0}) must be a multiple of "
                             f"nstr ({nstr})")
        cyc0 = jnp.asarray(step0) // nstr

        def cycle(carry, _):
            at, c = carry
            _, afor, _ = xforc(at.pam, None, sst_mean, at.astm,
                               at.hmixam)

            def abody(a, i):
                a, _diags = step(a, afor)
                a = jax.lax.cond((c * nstr + i) % ATMOS_AVG_PERIOD == 0,
                                 average_atmos_levels, lambda s: s, a)
                return a, None

            at, _ = jax.lax.scan(abody, at, jnp.arange(nstr))
            return (at, c + 1), None

        (state, _), _ = jax.lax.scan(cycle, (state, cyc0), None,
                                     length=n_cycles)
        return state

    if jit:
        run = jax.jit(run, static_argnames=("n_steps",))
    return run


def make_coupled_runner(model: Model, jit: bool = True, mesh=None,
                        spectral_variant=None, halo_variant=None,
                        remat: bool = False):
    """Fully coupled ocean-atmosphere stepping (main loop
    q-gcm.F:1220-1491): every atmospheric step runs the atmosphere;
    every nstr-th step first recomputes the forcing (xforc) and takes
    one ocean substep with dto = nstr*dta.

    Returns run(ocean, atmos, n_steps, step0=0) -> (ocean, atmos).
    `n_steps` counts ATMOSPHERIC steps; step0 keeps the coupling and
    averaging cadences aligned across host-side chunks.
    `spectral_variant='a2a'` routes both fluids' PV-inversion
    transforms through explicit all_to_all pencil transposes
    (parallel/spectral.py); `halo_variant` routes the ocean vorticity
    stencils through the explicit shard_map halo path (which also
    keeps the fused Pallas kernel on mesh runs). With a mesh, xforc
    runs in its small-collective layout (coupling.make_xforc).
    remat=True enables per-cycle jax.checkpoint for reverse-mode
    differentiation (adjoint.py).
    """
    from ..coupling import make_xforc
    if mesh is not None and spectral_variant == "a2a":
        from ..parallel.spectral import wrap_inversions
        model = wrap_inversions(model, mesh)
    xforc = make_xforc(model, mesh=mesh)
    ostep = make_ocean_step(model, halo=(mesh, halo_variant)
                            if (mesh is not None and halo_variant)
                            else None)
    astep = make_atmos_step(model)
    nstr = model.cfg.nstr
    if mesh is not None:
        from ..parallel.mesh import constrain_tree

    def run(ocean: OceanState, atmos: AtmosState, n_steps: int, step0=0):
        n_cycles = _split_cycles(n_steps, nstr)
        if isinstance(step0, int) and step0 % nstr:
            raise ValueError(f"step0 ({step0}) must be a multiple of "
                             f"nstr ({nstr})")
        cyc0 = jnp.asarray(step0) // nstr

        # Time loop structured as coupling CYCLES (xforc + one ocean
        # substep + nstr atmos steps) -- branchless, with no per-step
        # lax.cond around the coupling.
        def cycle(carry, _):
            oc, at, c = carry
            if mesh is not None:
                oc = constrain_tree(oc, mesh)
                at = constrain_tree(at, mesh)
            ofor, afor, _xdiags = xforc(at.pam, oc.pom, oc.sstm,
                                        at.astm, at.hmixam)
            oc, _odiags = ostep(oc, ofor)
            oc = jax.lax.cond(c % OCEAN_AVG_PERIOD == 0,
                              average_ocean_levels, lambda s: s, oc)

            def abody(a, i):
                a, _adiags = astep(a, afor)
                a = jax.lax.cond((c * nstr + i) % ATMOS_AVG_PERIOD == 0,
                                 average_atmos_levels, lambda s: s, a)
                return a, None

            at, _ = jax.lax.scan(abody, at, jnp.arange(nstr))
            return (oc, at, c + 1), None

        # per-CYCLE (multi-level) rematerialisation (adjoint.py): the
        # backward pass stores bounded (ocean, atmos) carries and
        # recomputes xforc + substeps' internals
        ocean, atmos, _ = _remat_scan(cycle, (ocean, atmos, cyc0),
                                      n_cycles, remat)
        return ocean, atmos

    if jit:
        run = jax.jit(run, static_argnames=("n_steps",))
    return run
