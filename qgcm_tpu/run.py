"""Experiment driver: the reference main program's run loop.

Replaces the orchestration half of src/q-gcm.F (main loop
q-gcm.F:1220-1491) and the Ruby case workflow (exec_qgcm.rb): builds
the model, initialises state (zero / rbal / restart file), then runs
the time loop as jitted `lax.scan` chunks -- physics and running-mean
accumulation stay on device; the host wakes only at I/O-cadence
boundaries to run the validity scan, write snapshots/monitoring/
restart files, and print progress.

Cadences (converted from days to steps as in q-gcm.F:656-698, which
rounds every interval to a whole number of coupling cycles -- "Do all
dumps when atmos. and ocean are in step"; cadence_rounding="exact"
keeps this framework's extension of honouring any whole atmospheric
step instead):
  valday -> validity scan      odiday/adiday -> snapshot dumps
  dgnday -> monitoring         prtday -> stdout sample
  resday -> restart dump (only written if the state passes valids --
            last-good-checkpoint semantics, q-gcm.F:1413-1416)
  dtavoc/dtavat -> running means written to avges.nc
Events fire on the RELATIVE step count since run start, matching the
reference's mod(ntdone, nout*) tests with ntdone = nt - nsteps0
(q-gcm.F:1271-1272,1277): a resumed run restarts every cadence clock
at the resume point.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .model import Model, build_model
from .params import RunParams, params_to_config, write_matlab_params, \
    SECDAY, SECSYR
from .state import OceanState, AtmosState, OceanForcing, AtmosForcing
from .models.ocean import (make_ocean_step, init_ocean_state,
                           ocean_forcing_from_mean)
from .models.atmos import make_atmos_step, init_atmos_state
from .models.stepper import (average_ocean_levels, average_atmos_levels,
                             OCEAN_AVG_PERIOD, ATMOS_AVG_PERIOD)
from .diags import valids, compute_monitor, MonitorWriter
from .diags.timavge import (zero_ocean_averages, zero_atmos_averages,
                            accumulate_ocean, accumulate_atmos,
                            write_avges)
from .diags.covaria import (zero_cov, cov_size, accumulate_cov,
                            write_covar)
from .diags.areas import build_area_boxes, area_averages, AreasWriter
from .diags.qocdiag import qocdiag_terms, QocdiagWriter
from .io import (save_restart, load_restart, load_restart_forcing,
                 OceanSnapshots, AtmosSnapshots, read_mean_forcing,
                 read_mean_sst)


def _gcd_all(vals):
    """gcd of the nonzero entries; 0 when none are set."""
    g = 0
    for v in vals:
        if v:
            g = math.gcd(g, int(v))
    return g


def _nint(x: float) -> int:
    """Fortran NINT for non-negative x: round half AWAY FROM ZERO.
    Python's round() is banker's rounding (round(2.5) == 2 but
    nint(2.5) == 3), which would silently shift any cadence that
    lands exactly on a half cycle/step."""
    return int(math.floor(x + 0.5))


@dataclass
class RunResult:
    ocean: Optional[OceanState]
    atmos: Optional[AtmosState]
    steps_done: int
    tyrs: float
    aborted: bool
    # (steps, wall seconds) of each chunk, its cadence events included;
    # the first chunk's time includes compilation
    chunk_walls: tuple = ()


class Driver:
    def __init__(self, model: Model, params: RunParams, outdir: str,
                 sst_mean=None, mean_forcing=None, verbose: bool = True,
                 areas_limits: str = None, qoc_diag: bool = False,
                 ocavg_days: float = 0.0, nscvoc: int = 4,
                 nscvat: int = 2, profile_dir: str = None,
                 mesh=None, spectral_variant: str = "a2a",
                 halo_variant: str = "auto",
                 cadence_rounding: str = "cycles",
                 ckpt_format: str = "netcdf",
                 avges_sampling: str = "mean"):
        """mesh: optional jax.sharding.Mesh ('y','x') for multi-chip
        runs -- the physics chunk carries 2-D spatial shardings and,
        with spectral_variant='a2a' (default), routes the PV-inversion
        transforms through the explicit all_to_all pencil solvers
        (parallel/spectral.py); halo_variant routes the ocean
        vorticity stencil through the shard_map ppermute path
        (parallel/halo.py). The default 'auto' picks the 'overlap'
        schedule on any mesh (strictly fewer collectives than GSPMD's
        auto stencil halos, tests/test_halo.py); meshes
        with x > 1 take the 2-D (y,x) halo decomposition for box
        oceans, while CYCLIC channels are rows-only by design and
        fall back to GSPMD with a warning when x is sharded.
        Pass None to force GSPMD. I/O and event diagnostics are
        unchanged (writers gather to host at cadence boundaries
        only).

        cadence_rounding: "cycles" (default) rounds every cadence to a
        whole number of coupling cycles exactly like the reference
        (nint(days*secday/dto)*nstr, q-gcm.F:656-698 -- "Do all dumps
        when atmos. and ocean are in step"); "exact" honours any whole
        atmospheric step, a deliberate extension over the reference
        (chunk boundaries then fall mid-cycle and the chunk program
        runs partial-cycle lead/tail segments).

        ckpt_format: "netcdf" (default) writes the reference's
        restart.nc schema, gathering the state to the host; "orbax"
        writes sharded checkpoint directories (restart_orbax/,
        lastday_orbax/) where each process stores its own shards --
        the at-scale path for multi-host runs (SURVEY 5.4; restart.nc
        at NAtl size is ~1.2 GB gathered). Resume accepts either: a
        directory path in input.params' name field loads an Orbax
        checkpoint (restored directly into the run's mesh sharding),
        a file loads restart.nc.

        avges_sampling: "mean" (default) accumulates the avges.nc
        running means EVERY (sub)step -- true time means, a documented
        departure (PARITY.md row 29). "midpoint" reproduces the
        reference exactly: ONE sample per averaging interval, taken at
        the interval's midpoint step nmid = ntav/2 on the relative
        ntdone grid (q-gcm.F:674-694 ntav/nmid setup, :1477-1482
        mod(ntdone,ntav).eq.nmid sampling). The reference requires an
        even whole-cycle interval; with cadence_rounding="cycles" that
        holds whenever nint(dtav*secday/dto) is even."""
        cfg = model.cfg
        self.model = model
        self.mesh = mesh
        self.spectral_variant = spectral_variant
        if halo_variant == "auto":
            any_sharded = (mesh is not None
                           and (mesh.shape.get("x", 1) > 1
                                or mesh.shape.get("y", 1) > 1))
            x_sharded = (mesh is not None
                         and mesh.shape.get("x", 1) > 1)
            if x_sharded and cfg.cyclic_ocean:
                # cyclic channels are rows-only by design (the
                # duplicated-column wraparound loses when x is
                # sharded; parallel/mesh.make_mesh) -- the halo path
                # refuses them, so fall back to GSPMD and warn
                halo_variant = None
                import warnings
                warnings.warn(
                    "mesh decomposes x on a CYCLIC ocean: the halo "
                    "schedule decomposes channels over rows only, so "
                    "stencils fall back to GSPMD auto halos. Rows-only "
                    "meshes (make_mesh(rows_only=True) / qgcm run "
                    "--mesh rows|auto) keep the wraparound local.",
                    stacklevel=2)
            else:
                # box configs keep the explicit schedule on ANY mesh
                # shape: rows-only takes the 'overlap' row path, x>1
                # the 2-D (y,x) decomposition (parallel/halo.py)
                halo_variant = "overlap" if any_sharded else None
        self.halo_variant = halo_variant
        self.p = params
        self.outdir = outdir
        self.verbose = verbose
        os.makedirs(outdir, exist_ok=True)

        self.has_oc = not cfg.atmos_only
        self.has_at = not cfg.ocean_only
        p = params
        dta, nstr = cfg.dta, cfg.nstr
        if cadence_rounding not in ("cycles", "exact"):
            raise ValueError("cadence_rounding must be 'cycles' or "
                             f"'exact', got {cadence_rounding!r}")
        self.cadence_rounding = cadence_rounding
        if ckpt_format not in ("netcdf", "orbax"):
            raise ValueError("ckpt_format must be 'netcdf' or "
                             f"'orbax', got {ckpt_format!r}")
        self.ckpt_format = ckpt_format
        if avges_sampling not in ("mean", "midpoint"):
            raise ValueError("avges_sampling must be 'mean' or "
                             f"'midpoint', got {avges_sampling!r}")
        self.avges_sampling = avges_sampling

        def steps(days, what=""):
            """Cadence in atmospheric steps.  Default ("cycles"): the
            reference's rounding to whole coupling cycles,
            nint(days*secday/dto)*nstr (q-gcm.F:656-698, "Do all dumps
            when atmos. and ocean are in step").  "exact": any whole
            atmospheric step is honoured (this framework's extension;
            chunk boundaries may fall mid-coupling-cycle and the chunk
            program runs partial-cycle lead/tail segments, see
            chunk_fn).  Warn whenever the requested time is rounded."""
            if days <= 0:
                return 0
            if cadence_rounding == "cycles":
                n = max(1, _nint(days * SECDAY / (nstr * dta))) * nstr
            else:
                n = max(1, _nint(days * SECDAY / dta))
            if abs(n * dta - days * SECDAY) > 1e-6 * dta:
                import warnings
                unit = ("coupling cycles (dto=nstr*dta="
                        f"{nstr * dta}s, q-gcm.F:656-698 rounding; "
                        "pass cadence_rounding='exact' for whole-"
                        "atmos-step cadences)"
                        if cadence_rounding == "cycles" else
                        f"atmospheric steps (dta={dta}s)")
                warnings.warn(
                    f"{what or 'cadence'} of {days} days is not a "
                    f"whole number of {unit}; rounding to {n} steps "
                    f"= {n * dta / SECDAY} days",
                    stacklevel=3)
            return n

        # nint like the reference's nsteps derivation
        # (q-gcm.F:649-651)
        self.nsteps = max(1, _nint(p.trun * SECSYR / dta))
        self.nvalid = steps(p.valday, "valday")
        self.noutoc = steps(p.odiday, "odiday")
        self.noutat = steps(p.adiday, "adiday")
        self.nmonit = steps(p.dgnday, "dgnday")
        self.nprint = steps(p.prtday, "prtday")
        self.nrestart = steps(p.resday, "resday")
        self.ntavoc = steps(p.dtavoc, "dtavoc")
        self.ntavat = steps(p.dtavat, "dtavat")
        if avges_sampling == "midpoint":
            # the reference hard-stops on an odd interval ("Unsuitable
            # choice of dtavat/dtavoc", q-gcm.F:679-694): the midpoint
            # step ntav/2 must be whole
            for nm, ntav in (("dtavoc", self.ntavoc),
                             ("dtavat", self.ntavat)):
                if ntav % 2:
                    raise ValueError(
                        f"avges_sampling='midpoint' needs an even "
                        f"number of steps per averaging interval; "
                        f"{nm} gives {ntav} (q-gcm.F:679-694)")
        self.ncovoc = steps(p.dtcovoc, "dtcovoc")
        self.ncovat = steps(p.dtcovat, "dtcovat")
        self.nocavg = steps(ocavg_days, "ocavg_days")
        self.chunk = _gcd_all([
            self.nvalid, self.noutoc, self.noutat, self.nmonit,
            self.nprint, self.nrestart, self.ntavoc, self.ntavat,
            self.ncovoc, self.ncovat, self.nocavg])
        cadence_chunk = bool(self.chunk)
        if not self.chunk:
            # No cadence enabled: nothing forces a host wake-up, so
            # run big jitted chunks (one cycle per dispatch would pay
            # a dispatch round-trip per substep). Capped so a single
            # dispatch stays minutes, not hours, even at NAtl scale.
            # Prefer a chunk that DIVIDES the run: a different-length
            # final chunk is a second static n_steps value and
            # recompiles the whole chunk program.
            cap_cycles = 4096
            cycles = max(1, self.nsteps // nstr)
            if cycles <= cap_cycles:
                self.chunk = self.nsteps
            else:
                div = max((d for d in range(cap_cycles, 0, -1)
                           if cycles % d == 0), default=1)
                # degenerate divisors (e.g. prime cycle counts) would
                # make dispatch overhead matter again; accept one
                # remainder-size recompile instead
                self.chunk = (div if div >= 256 else cap_cycles) * nstr
                if self.nsteps % self.chunk:
                    import warnings
                    warnings.warn(
                        f"run length ({cycles} cycles) has no "
                        f"divisor in [256, {cap_cycles}]; using chunk "
                        f"= {self.chunk // nstr} cycles, so the final "
                        f"remainder chunk is a second program and "
                        f"pays one extra compile (minutes at large "
                        f"grid sizes) before it dispatches",
                        stacklevel=3)
        self.chunk = max(self.chunk, 1)
        if cadence_chunk and self.chunk % nstr:
            # only reachable with cadence_rounding="exact" (a
            # no-cadence fallback chunk of nsteps % nstr != 0 is still
            # a single phase/program and must not warn): chunk
            # boundaries rotate through the coupling-cycle phases, and
            # every distinct (n_steps, phase) pair is its own compiled
            # chunk program
            import warnings
            warnings.warn(
                f"cadence chunk of {self.chunk} steps is not a whole "
                f"number of coupling cycles (nstr={nstr}): chunk "
                f"boundaries rotate through up to {nstr} in-cycle "
                f"phases and each compiles its own chunk program "
                f"(minutes each at large grid sizes)",
                stacklevel=2)
        self.areas_limits = areas_limits
        self.qoc_diag = qoc_diag
        self.nscvoc, self.nscvat = nscvoc, nscvat
        self.profile_dir = profile_dir

        # static surface fields for single-fluid modes
        self.sst_mean = (jnp.asarray(sst_mean, jnp.dtype(cfg.dtype))
                         if sst_mean is not None else None)
        self.mean_forcing = mean_forcing   # (tauxo, tauyo, fnetoc)

        self._build_step_fns()

    # ------------------------------------------------------------------
    def _build_step_fns(self):
        model = self.model
        cfg = model.cfg
        nstr = cfg.nstr
        has_oc, has_at = self.has_oc, self.has_at

        mesh = self.mesh
        step_model = model
        constrain = None
        if mesh is not None:
            from .parallel.mesh import constrain_tree
            constrain = constrain_tree
            if self.spectral_variant == "a2a":
                from .parallel.spectral import wrap_inversions
                step_model = wrap_inversions(model, mesh)

        halo = ((mesh, self.halo_variant)
                if (mesh is not None and self.halo_variant) else None)
        ostep = make_ocean_step(step_model, halo=halo) if has_oc else None
        astep = make_atmos_step(step_model) if has_at else None
        if has_at:
            from .coupling import make_xforc
            # mesh-aware layout: no collective above coarse-atmos size
            xforc = make_xforc(model, mesh=mesh)

        # avges sampling: "mean" accumulates every (sub)step; the
        # reference-parity "midpoint" mode accumulates ONE sample per
        # averaging interval at its midpoint step on the relative
        # ntdone grid (mod(ntdone,ntav).eq.nmid, q-gcm.F:1477-1482
        # with nmid = ntav/2, :683/:694)
        midpoint = self.avges_sampling == "midpoint"
        nmidat = self.ntavat // 2
        nmidoc = self.ntavoc // 2

        def acc_at(aacc, at2, afor, ntdone):
            if not (midpoint and self.ntavat):
                return accumulate_atmos(aacc, at2, afor, model)
            return jax.lax.cond(
                ntdone % self.ntavat == nmidat,
                lambda a: accumulate_atmos(a, at2, afor, model),
                lambda a: a, aacc)

        def acc_oc(oacc, oc, ofor, rel_n):
            if not (midpoint and self.ntavoc):
                return accumulate_ocean(oacc, oc, ofor, model)
            # the ocean state/forcing sampled by tavocn at the (atmos-
            # step) midpoint ntdone are the ones set at the head of the
            # coupling cycle CONTAINING that step (the ocean substep
            # runs only at mod(nt,nstr)==1, q-gcm.F:1222); this head
            # covers ntdone in [rel_n+1, rel_n+nstr]
            hit = ((rel_n + nstr) - nmidoc) % self.ntavoc < nstr
            return jax.lax.cond(
                hit, lambda a: accumulate_ocean(a, oc, ofor, model),
                lambda a: a, oacc)

        def atmos_seg(at, aacc, afor, n0, length, step0):
            """`length` (static) atmospheric steps from global atmos
            step index n0 (dynamic, 0-based; step0 = nsteps0 puts the
            cadence predicates on the relative ntdone grid)."""
            def abody(carry2, i):
                at2, aacc2 = carry2
                at2, _ = astep(at2, afor)
                at2 = jax.lax.cond(
                    (n0 + i) % ATMOS_AVG_PERIOD == 0,
                    average_atmos_levels, lambda s: s, at2)
                aacc2 = acc_at(aacc2, at2, afor, n0 + i + 1 - step0)
                return (at2, aacc2), None
            (at, aacc), _ = jax.lax.scan(
                abody, (at, aacc), jnp.arange(length))
            return at, aacc

        def cycle_start(oc, at, ofor, afor, oacc, n, step0):
            """Coupling-cycle head: forcing + ocean substep (the
            reference's mod(nt,nstr)==1 block, q-gcm.F:1222-1249),
            entered only when n % nstr == 0."""
            if has_at and has_oc:            # coupled
                ofor, afor, _ = xforc(at.pam, oc.pom, oc.sstm,
                                      at.astm, at.hmixam)
                oc, _ = ostep(oc, ofor)
                oacc = acc_oc(oacc, oc, ofor, n - step0)
            elif has_oc:                     # ocean only (static ofor)
                oc, _ = ostep(oc, ofor)
                oacc = acc_oc(oacc, oc, ofor, n - step0)
            elif has_at:                     # atmos only
                _, afor, _ = xforc(at.pam, None, self.sst_mean,
                                   at.astm, at.hmixam)
            if has_oc:
                oc = jax.lax.cond((n // nstr) % OCEAN_AVG_PERIOD == 0,
                                  average_ocean_levels,
                                  lambda s: s, oc)
            return oc, at, ofor, afor, oacc

        def constrained(oc, at):
            if constrain is not None:
                if has_oc:
                    oc = constrain(oc, mesh)
                if has_at:
                    at = constrain(at, mesh)
            return oc, at

        def chunk_fn(carry, n_steps, phase, step0):
            # Branchless cycle structure (xforc + ocean substep + nstr
            # atmos steps), no per-step lax.cond around the coupling.
            # Cadences are honoured at
            # ANY whole atmospheric step like the reference
            # (q-gcm.F:640-700): `phase` (static) = position within the
            # coupling cycle at chunk entry, so a chunk may open with a
            # partial cycle's trailing atmos steps (lead, the cycle's
            # forcing/ocean already ran last chunk) and close with a
            # fresh cycle head + partial atmos tail.  Aligned runs
            # (phase 0, nstr | n_steps) compile to the pure cycle scan.
            oc, at, ofor, afor, oacc, aacc, n = carry
            lead = min(n_steps, (nstr - phase) % nstr)
            if lead and has_at:
                at, aacc = atmos_seg(at, aacc, afor, n, lead, step0)
            if lead:
                n = n + lead
            n_cycles, tail = divmod(n_steps - lead, nstr)

            def cycle(c_carry, _):
                oc, at, ofor, afor, oacc, aacc, n = c_carry
                oc, at = constrained(oc, at)
                oc, at, ofor, afor, oacc = cycle_start(
                    oc, at, ofor, afor, oacc, n, step0)
                if has_at:
                    at, aacc = atmos_seg(at, aacc, afor, n, nstr,
                                         step0)
                return (oc, at, ofor, afor, oacc, aacc, n + nstr), None

            if n_cycles:
                (out, _) = jax.lax.scan(
                    cycle, (oc, at, ofor, afor, oacc, aacc, n), None,
                    length=n_cycles)
                oc, at, ofor, afor, oacc, aacc, n = out
            if tail:
                oc, at = constrained(oc, at)
                oc, at, ofor, afor, oacc = cycle_start(
                    oc, at, ofor, afor, oacc, n, step0)
                if has_at:
                    at, aacc = atmos_seg(at, aacc, afor, n, tail,
                                         step0)
                n = n + tail
            return (oc, at, ofor, afor, oacc, aacc, n)

        self._chunk_fn = jax.jit(chunk_fn,
                                 static_argnames=("n_steps", "phase"))
        self._xforc = jax.jit(xforc) if has_at else None

        # Event diagnostics run on-device in ONE dispatch each: un-jitted
        # they issue dozens-to-hundreds of ops, each a dispatch.  Grid-sized
        # model arrays (integral weights, topography) are passed as
        # device-resident ARGUMENTS, not closure constants, so the
        # compiled programs stay constant-free at any grid size.
        import dataclasses
        from .diags.cfl import cfl_numbers
        wop_d = jnp.asarray(model.wop)
        wap_d = jnp.asarray(model.wap)
        dtopoc_d = jnp.asarray(model.topo.dtopoc)

        def _with_arrays(wop, wap, dtop):
            topo = dataclasses.replace(model.topo, dtopoc=dtop)
            return dataclasses.replace(model, wop=wop, wap=wap, topo=topo)

        @jax.jit
        def _valids_j(oc, at, ofor, afor, wop, wap, dtop):
            return valids(_with_arrays(wop, wap, dtop), oc, at, ofor, afor)

        @jax.jit
        def _monitor_j(oc, at, ofor, afor, xdiags, wop, wap, dtop):
            return compute_monitor(_with_arrays(wop, wap, dtop), oc, at,
                                   ofor, afor, xdiags=xdiags)

        @jax.jit
        def _cfl_j(oc, at, ofor, afor):
            return cfl_numbers(model, oc, at, ofor, afor)

        self._valids = lambda oc, at, ofor, afor: \
            _valids_j(oc, at, ofor, afor, wop_d, wap_d, dtopoc_d)
        self._monitor = lambda oc, at, ofor, afor, xdiags=None: \
            _monitor_j(oc, at, ofor, afor, xdiags, wop_d, wap_d, dtopoc_d)
        self._cfl = _cfl_j

    # ------------------------------------------------------------------
    @staticmethod
    def _host_device():
        """Device for init-time work.  State/forcing construction is a
        chain of small eager ops (each a dispatch on an accelerator),
        so build on the local CPU and let the first jitted chunk
        transfer the finished arrays once."""
        try:
            return jax.devices("cpu")[0]
        except RuntimeError:        # no CPU backend registered
            return jax.devices()[0]

    def _initial_state(self):
        model, p = self.model, self.p
        cfg = model.cfg
        tini = 0.0
        self._stored_forcing = (None, None)
        with jax.default_device(self._host_device()):
            if p.name in ("zero", "rbal"):
                oc = init_ocean_state(model, init=p.name)
                at = init_atmos_state(model, init=p.name)
            elif os.path.isdir(p.name):
                # Orbax checkpoint directory (ckpt_format="orbax"):
                # each process restores its own shards, directly into
                # the run's mesh sharding when one is set
                from .io.orbax_ckpt import load_checkpoint
                oc, at, tini = load_checkpoint(
                    os.path.abspath(p.name), model, mesh=self.mesh)
            else:
                oc, at, tini = load_restart(p.name, model)
                # mid-cycle dumps embed the open cycle's forcing;
                # using it (instead of recomputing from the advanced
                # m-slots) keeps the resumed trajectory faithful
                self._stored_forcing = load_restart_forcing(p.name,
                                                            model)
        if cfg.atmos_only and self.sst_mean is None:
            raise ValueError("atmos_only run needs a mean SST field "
                             "(sst_mean= or avges.nc)")
        return oc, at, tini

    def _save_ckpt(self, base, oc, at, tyrs, n_done, ofor, afor):
        """One checkpoint dump in the configured format ('restart' or
        'lastday' base name)."""
        if self.ckpt_format == "orbax":
            fk = self._midcycle_forcing(n_done, ofor, afor)
            if fk:
                import warnings
                warnings.warn(
                    "orbax checkpoints do not embed mid-cycle "
                    "forcing; the resume recomputes it from the "
                    "advanced m-slots (exact-cadence mid-cycle dumps "
                    "are only trajectory-faithful with "
                    "ckpt_format='netcdf')", stacklevel=3)
            from .io.orbax_ckpt import save_checkpoint
            save_checkpoint(os.path.abspath(
                f"{self.outdir}/{base}_orbax"), oc, at, tyrs)
        else:
            save_restart(f"{self.outdir}/{base}.nc", self.model, oc,
                         at, tyrs,
                         **self._midcycle_forcing(n_done, ofor, afor))

    def _midcycle_forcing(self, n_done, ofor, afor):
        """kwargs for save_restart: embed the open cycle's forcing when
        the dump lands mid coupling cycle (exact-cadence extension; a
        cycle-aligned dump stays byte-compatible with the reference
        restart schema and the resume recomputes forcing via xforc,
        q-gcm.F:870)."""
        if not self.has_at or (self._step0 + n_done) % \
                self.model.cfg.nstr == 0:
            return {}
        return {"ofor": ofor if self.has_oc else None, "afor": afor}

    def _initial_forcing(self, oc, at):
        with jax.default_device(self._host_device()):
            return self._initial_forcing_impl(oc, at)

    def _initial_forcing_impl(self, oc, at):
        cfg = self.model.cfg
        dtype = jnp.dtype(cfg.dtype)
        sofor, safor = getattr(self, "_stored_forcing", (None, None))
        if self.has_at and safor is not None and \
                (sofor is not None or not self.has_oc):
            # resume from a mid-cycle dump: the open cycle's remaining
            # lead atmos steps must run under the SAME forcing the
            # uninterrupted run used (computed at the cycle head)
            ofor, afor = sofor, safor
        elif self.has_at:
            ofor, afor, _ = self._xforc(
                at.pam, oc.pom if self.has_oc else None,
                oc.sstm if self.has_oc else self.sst_mean,
                at.astm, at.hmixam)
        else:
            if self.mean_forcing is None:
                raise ValueError("ocean_only run needs mean forcing "
                                 "(tauxo, tauyo, fnetoc)")
            ofor = ocean_forcing_from_mean(self.model,
                                           *self.mean_forcing)
            afor = None
        if ofor is None:
            # atmos_only: placeholder zeros keep the carry structure
            ofor = jax.tree_util.tree_map(
                jnp.zeros_like,
                ocean_forcing_from_mean(
                    self.model, np.zeros((cfg.nypo, cfg.nxpo)),
                    np.zeros((cfg.nypo, cfg.nxpo)),
                    np.zeros((cfg.nyto, cfg.nxto))))
        if afor is None:
            # placeholder pytree so the scan carry is fixed-structure
            z = jnp.zeros((), dtype)
            afor = AtmosForcing(
                tauxa=jnp.zeros((cfg.nypa, cfg.nxpa), dtype),
                tauya=jnp.zeros((cfg.nypa, cfg.nxpa), dtype),
                fnetat=jnp.zeros((cfg.nyta, cfg.nxta), dtype),
                wekta=jnp.zeros((cfg.nyta, cfg.nxta), dtype),
                wekpa=jnp.zeros((cfg.nypa, cfg.nxpa), dtype),
                uekat=jnp.zeros((cfg.nyta, cfg.nxpa), dtype),
                vekat=jnp.zeros((cfg.nypa, cfg.nxta), dtype),
                txisat=z, txinat=z)
        return ofor, afor

    # ------------------------------------------------------------------
    def run(self) -> RunResult:
        model, p, out = self.model, self.p, self.outdir
        cfg = model.cfg
        dtype = jnp.dtype(cfg.dtype)
        oc, at, tini = self._initial_state()
        ofor, afor = self._initial_forcing(oc, at)
        step0 = _nint(tini * SECSYR / cfg.dta)   # nsteps0, q-gcm.F:649
        self._step0 = step0

        write_matlab_params(f"{out}/input_parameters.m", p, cfg, model,
                            tini=tini, nscvoc=self.nscvoc,
                            nscvat=self.nscvat)
        if model.topo.dtopoc.any() or model.topo.dtopat.any():
            from .topo import write_topog
            write_topog(f"{out}/topog.nc", model)
        from .report import startup_report, sample_report, \
            memory_report
        self._log(startup_report(model))
        self._log(memory_report(model))

        osnap = (OceanSnapshots(out, model, flags=p.outfloc,
                                stride=p.nsko)
                 if self.has_oc and self.noutoc else None)
        asnap = (AtmosSnapshots(out, model, flags=p.outflat,
                                stride=p.nska)
                 if self.has_at and self.noutat else None)
        monw = MonitorWriter(f"{out}/monit.nc", model) \
            if self.nmonit else None
        boxes = areasw = None
        if self.areas_limits and self.nmonit:
            boxes = build_area_boxes(model, self.areas_limits)
            areasw = AreasWriter(f"{out}/areas.nc", boxes)
        qocw = (QocdiagWriter(f"{out}/qocdiag.nc", model, stride=p.nsko)
                if self.qoc_diag and self.has_oc and self.noutoc
                else None)
        covs = {}
        _acc_cov = jax.jit(accumulate_cov,
                           static_argnames=("nsi", "grid"))
        if self.ncovoc and self.has_oc:
            covs["po"] = zero_cov(cov_size(cfg.nypo, cfg.nxpo,
                                           self.nscvoc, grid="p"))
            covs["to"] = zero_cov(cov_size(cfg.nyto, cfg.nxto,
                                           self.nscvoc))
        if self.ncovat and self.has_at:
            covs["pa"] = zero_cov(cov_size(cfg.nypa, cfg.nxpa,
                                           self.nscvat, grid="p"))
            covs["ta"] = zero_cov(cov_size(cfg.nyta, cfg.nxta,
                                           self.nscvat))
        if self.nocavg:
            os.makedirs(f"{out}/avg", exist_ok=True)
        n_ocavg = 0
        oacc_mark = None

        oacc = zero_ocean_averages(cfg, dtype)
        aacc = zero_atmos_averages(cfg, dtype)
        carry = (oc, at, ofor, afor, oacc, aacc, jnp.asarray(step0))
        # Init built the state on the host CPU (cheap eager ops).  Hand
        # the first jitted chunk plain NumPy leaves: jit uploads host
        # data itself, onto the run's devices.
        # Arrays an Orbax restore already DISTRIBUTED over the mesh
        # are kept as-is (fetching them would gather the global state
        # to one host -- the thing the sharded restore avoids).
        def _to_host(x):
            if isinstance(x, jax.Array) and \
                    len(getattr(x.sharding, "device_set", ())) > 1:
                return x
            return np.asarray(x)
        carry = jax.tree_util.tree_map(_to_host, carry)
        if self.mesh is not None and self.mesh.devices.size > 1:
            # Multi-chip run: place the initial state distributed
            # (evenly divisible fields; the chunk's constraints settle
            # the N+1 p-grids -- parallel/mesh.py notes).
            from .parallel.mesh import shard_tree
            carry = shard_tree(carry, self.mesh)
        oc, at, ofor, afor, oacc, aacc, _ = carry
        aborted = False
        n_done = 0
        # --profile: trace the third chunk (steady state -- chunk 0
        # compiles, chunk 1 recompiles for settled array layouts).
        step0_h = np.asarray(step0)   # host scalar; jit uploads once
        n_chunks = -(-self.nsteps // self.chunk)
        prof_chunk = min(2, n_chunks - 1) if self.profile_dir else -1
        prof_steps = 0
        i_chunk = 0
        t0 = time.time()
        chunk_walls = []
        t_chunk = time.perf_counter()
        nstr = cfg.nstr
        while n_done < self.nsteps:
            # chunk boundaries on the RELATIVE step grid: cadences key
            # on the step count since run start, like the reference's
            # mod(ntdone, nout*) tests with ntdone = nt - nsteps0
            # (q-gcm.F:1271-1272,1277,1411-1489).  The coupling-cycle
            # PHASE stays on the absolute grid -- the reference's
            # ocean-substep test is mod(nt, nstr).eq.1 on the absolute
            # nt (q-gcm.F:1222) -- so a resume from a mid-cycle dump
            # re-enters the open cycle at the right point.
            n = min(self.chunk, self.nsteps - n_done)
            phase = (step0 + n_done) % nstr
            if i_chunk == prof_chunk:
                from jax import profiler as _jprof
                with _jprof.trace(self.profile_dir):
                    carry = self._chunk_fn(carry, n, phase, step0_h)
                    jax.block_until_ready(carry)
                prof_steps = n
            else:
                carry = self._chunk_fn(carry, n, phase, step0_h)
            i_chunk += 1
            n_done += n
            oc, at, ofor, afor, oacc, aacc, _ = carry
            tyrs = tini + n_done * cfg.dta / SECSYR

            def due(cad):
                return cad and n_done % cad == 0

            if due(self.nvalid):
                rep = self._valids(oc if self.has_oc else None,
                                   at if self.has_at else None, ofor, afor)
                if not bool(rep.ok):
                    # fail-fast with post-mortem artifacts
                    if osnap:
                        osnap.append(oc, ofor, tyrs)
                    if asnap:
                        asnap.append(at, afor, tyrs)
                    if monw:
                        monw.append(self._monitor(
                            oc if self.has_oc else None,
                            at if self.has_at else None, ofor, afor),
                            tyrs)
                    self._log(f"VALIDITY FAILURE at step {n_done}: "
                              f"{rep}")
                    from .diags.valids import post_mortem
                    self._log(post_mortem(
                        model, oc if self.has_oc else None,
                        at if self.has_at else None, ofor, afor))
                    aborted = True
                    break
            if due(self.nmonit) and monw:
                xdiags = None
                if self.has_at and self.has_oc:
                    _, _, xdiags = self._xforc(
                        at.pam, oc.pom, oc.sstm, at.astm, at.hmixam)
                monw.append(self._monitor(
                    oc if self.has_oc else None,
                    at if self.has_at else None, ofor, afor,
                    xdiags), tyrs)
            if due(self.noutoc) and osnap:
                osnap.append(oc, ofor, tyrs)
            if due(self.noutat) and asnap:
                asnap.append(at, afor, tyrs)
            if due(self.ntavoc) or due(self.ntavat):
                write_avges(f"{out}/avges.nc", model,
                            oacc if self.has_oc else None,
                            aacc if self.has_at else None)
            if due(self.ncovoc):
                covs["po"] = _acc_cov(covs["po"], oc.po[0],
                                      nsi=self.nscvoc, grid="p")
                covs["to"] = _acc_cov(covs["to"], oc.sst,
                                      nsi=self.nscvoc)
            if due(self.ncovat):
                covs["pa"] = _acc_cov(covs["pa"], at.pa[0],
                                      nsi=self.nscvat, grid="p")
                covs["ta"] = _acc_cov(covs["ta"], at.ast,
                                      nsi=self.nscvat)
            if areasw and due(self.nmonit):
                tavoc, tavat = area_averages(
                    boxes, oc.sst if self.has_oc else None,
                    at.ast if self.has_at else None)
                areasw.append(tyrs, tavoc, tavat)
            if qocw and due(self.noutoc):
                from .models.ocean import _oml
                entoc = (_oml(model, oc, ofor)[2] if not cfg.no_oml
                         else jnp.zeros_like(oc.po[0]))
                qocw.append(qocdiag_terms(model, oc, ofor, entoc),
                            tyrs)
            if due(self.nocavg):
                # k247 daily-mean po stream: window means by
                # differencing the cumulative accumulator
                from .io.ncdf import make_writer as NcWriter
                if oacc_mark is None:
                    pod = oacc.po / max(float(oacc.n), 1.0)
                else:
                    dn = max(float(oacc.n - oacc_mark.n), 1.0)
                    pod = (oacc.po - oacc_mark.po) / dn
                oacc_mark = oacc
                wnc = NcWriter(f"{out}/avg/ocavg_{n_ocavg:04d}.nc")
                wnc.dim("zo", cfg.nlo)
                wnc.dim("ypo", cfg.nypo); wnc.dim("xpo", cfg.nxpo)
                wnc.var("po", "f", ("zo", "ypo", "xpo"),
                        units="m^2/s^2", data=np.asarray(pod))
                wnc.close()
                n_ocavg += 1
            if due(self.nrestart):
                rep = self._valids(oc if self.has_oc else None,
                                   at if self.has_at else None, ofor, afor)
                if bool(rep.ok):      # last-good checkpoint only
                    self._save_ckpt("restart", oc, at, tyrs, n_done,
                                    ofor, afor)
            if due(self.nprint):
                wall = time.time() - t0
                cflr = self._cfl(oc if self.has_oc else None,
                                 at if self.has_at else None,
                                 ofor, afor)
                self._log(f"step {n_done}/{self.nsteps} t={tyrs:.4f}y "
                          f"wall={wall:.1f}s "
                          f"cfl(oc)={float(cflr.cnqgoc):.3f} "
                          f"cfl(at)={float(cflr.cnqgat):.3f}")
                self._log(sample_report(
                    model, oc if self.has_oc else None,
                    at if self.has_at else None))
            chunk_walls.append((n, time.perf_counter() - t_chunk))
            t_chunk = time.perf_counter()

        tyrs = tini + n_done * cfg.dta / SECSYR
        if not aborted:
            # the reference writes its final resave only at normal
            # termination (q-gcm.F:1528-1539); an aborted run must NOT
            # leave the invalid state as the newest checkpoint (the
            # post-mortem snapshots carry it, and restart.nc remains
            # the last state that PASSED valids)
            self._save_ckpt("lastday", oc, at, tyrs, n_done, ofor,
                            afor)
        write_avges(f"{out}/avges.nc", model,
                    oacc if self.has_oc else None,
                    aacc if self.has_at else None)
        if covs:
            write_covar(f"{out}/covar.nc", covs)
        for wtr in (osnap, asnap, monw, areasw, qocw):
            if wtr:
                wtr.close()
        if prof_steps:
            from .profiling import summarize
            try:
                self._log(f"profile ({self.profile_dir}):\n"
                          + summarize(self.profile_dir).report(
                              steps=prof_steps))
            except Exception as e:         # trace written, report best-effort
                self._log(f"profile summary unavailable: {e}")
        return RunResult(ocean=oc if self.has_oc else None,
                         atmos=at if self.has_at else None,
                         steps_done=n_done, tyrs=tyrs, aborted=aborted,
                         chunk_walls=tuple(chunk_walls))

    def _log(self, msg):
        if self.verbose:
            print(msg, flush=True)


def run_case(params: RunParams, base_config, outdir: str,
             sst_mean=None, mean_forcing=None, topoc="flat",
             topat="flat", verbose=True, **driver_kwargs) -> RunResult:
    """One-call experiment: merge params into the dimension-carrying
    base config, build the model and run."""
    cfg = params_to_config(params, base_config)
    topocname = params.topocname if params.topocname != "flat" else topoc
    topatname = params.topatname if params.topatname != "flat" else topat
    # 'extant' in input.params: use the pre-existing topography dataset
    # (topog.nc prepared earlier in the case directory,
    # topsubs.F:146-163 semantics)
    extant_oc = extant_at = None
    if "extant" in (topocname, topatname):
        case_dir = os.path.dirname(os.path.abspath(outdir))
        for cand in (os.path.join(case_dir, "topog.nc"),
                     os.path.join(outdir, "topog.nc")):
            if os.path.exists(cand):
                from .topo import _load_netcdf
                if topocname == "extant":
                    extant_oc = _load_netcdf(cand, "dtopoc",
                                             (cfg.nypo, cfg.nxpo))
                if topatname == "extant":
                    extant_at = _load_netcdf(cand, "dtopat",
                                             (cfg.nypa, cfg.nxpa))
                break
        else:
            raise FileNotFoundError(
                "topography 'extant' requested but no topog.nc found "
                "in the case or output directory")
    model = build_model(cfg, topocname=topocname, topatname=topatname,
                        extant_oc=extant_oc, extant_at=extant_at)
    if cfg.ocean_only and mean_forcing is None:
        mean_forcing = read_mean_forcing(f"{outdir}/avges_in.nc") \
            if os.path.exists(f"{outdir}/avges_in.nc") else None
    case_dir = os.path.dirname(os.path.abspath(outdir))
    limits = os.path.join(case_dir, "areas.limits")
    drv = Driver(model, params, outdir, sst_mean=sst_mean,
                 mean_forcing=mean_forcing, verbose=verbose,
                 areas_limits=limits if os.path.exists(limits) else None,
                 **driver_kwargs)
    return drv.run()
