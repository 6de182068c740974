#!/usr/bin/env python
"""Smoke test of the model on one NVIDIA GPU, at full published size.

    python chip_smoke.py              # one card: phases a-f below
    python chip_smoke.py --multichip  # four cards: mesh + member mesh

Phases (one card), each checked against the tolerance printed beside
its result; any failure ends the script with a traceback and a
non-zero exit code:

  a  device: the default JAX device must be a GPU (no CPU fallback).
  b  golden: both tests/test_golden.py cases in float64 on the card.
  d  main path: the double-gyre coupled case (961^2x3 ocean under a
     384x96x3 atmosphere) through run.run_case, the runner `qgcm run`
     calls, for 2 model days in float32; then 30 atmos steps through
     `qgcm run` itself in float64 and float32, compared.
  e  largest grid: NAtl 1 km (4801^2x3) ocean-only, a few steps.
  c  solver accuracy: box and channel Helmholtz solves at production
     widths, each float32 backend against the float64 FFT solve.
  f  vorticity step: device time of the plain jnp stencil chain at
     961^2x3 and 4801^2x3 against the HBM-bandwidth bound.

(d and e run before c so that their peak device memory is their own.)
The last line of standard output is one JSON object,
{"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Peak HBM bandwidth by jax device_kind (NVIDIA H100 SXM data sheet).
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def log(*a):
    print(*a, flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def rel_l2(a, b):
    import numpy as np
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def import_package():
    """Import qgcm_tpu from this script's own checkout, nowhere else."""
    if not os.path.isdir(os.path.join(HERE, "qgcm_tpu")):
        sys.exit(f"chip_smoke.py: no qgcm_tpu package beside {HERE}")
    sys.path.insert(0, HERE)
    import qgcm_tpu
    check(os.path.dirname(os.path.abspath(qgcm_tpu.__file__))
          == os.path.join(HERE, "qgcm_tpu"),
          f"qgcm_tpu imported from {qgcm_tpu.__file__}, not {HERE}")
    return qgcm_tpu


# ---------------------------------------------------------------- a
def phase_device(n_needed=1):
    import jax
    from qgcm_tpu import backend
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke.py: needs an NVIDIA GPU; JAX found "
                 f"{devs[0].platform!r} devices only")
    check(len(devs) >= n_needed, f"needs {n_needed} GPUs, found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(f"nvidia-smi: {smi}")
    log(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind} "
        f"({devs[0].platform})")
    log(f"compile cache: {backend.enable_compile_cache()}")
    return devs


def peak_bytes(dev):
    return dev.memory_stats()["peak_bytes_in_use"]


# ---------------------------------------------------------------- b
def phase_golden():
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import test_golden as g
    for name, fn, expected in (
            ("ocean_only_box", g.golden_ocean_only_box,
             g.EXPECTED_OCEAN_ONLY_BOX),
            ("coupled", g.golden_coupled, g.EXPECTED_COUPLED)):
        got = fn()
        worst = max(abs(got[k] - v) / abs(v) for k, v in expected.items())
        log(f"[b] golden {name} (float64): worst rel deviation from the "
            f"CPU constants {worst:.3e} (tolerance {g.RTOL:.0e})")
        check(worst <= g.RTOL, f"golden {name}: {worst:.3e} > {g.RTOL}")


# ---------------------------------------------------------------- c
SOLVER_RTOL = 2e-6      # float32 FFT and matmul vs float64 FFT


def phase_solver(box_sizes=(959, 4799), channel=(4609, 577)):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from qgcm_tpu.solver import helmholtz as hh

    rdm2 = np.array([0.0, 6.25e-10, 2.5e-9])   # 1/Rd^2: 40 and 20 km

    def run(solver, rhs):
        out = jax.jit(solver.solve)(rhs)
        return np.asarray(out)

    def report(label, make, shape):
        key = jax.random.PRNGKey(0)
        rhs = jax.random.normal(key, (len(rdm2),) + shape, jnp.float32)
        ref = run(make(jnp.float64, "fft"), rhs.astype(jnp.float64))
        for backend in hh.DST_BACKENDS:
            err = rel_l2(run(make(jnp.float32, backend), rhs), ref)
            log(f"[c] {label} f32 {backend}: rel err {err:.3e} "
                f"(bound {SOLVER_RTOL:.0e})")
            check(err <= SOLVER_RTOL, f"{label} {backend}: {err:.3e}")

    for n in box_sizes:
        nxp = n + 2
        report(f"box {n}^2 interior", lambda dt, t, nxp=nxp:
               hh.make_box_helmholtz(nxp, nxp, 5e3, 5e3, rdm2, dtype=dt,
                                     transform=t),
               (nxp, nxp))
    nxp, nyp = channel
    report(f"channel {nxp}x{nyp}", lambda dt, t:
           hh.make_cyclic_helmholtz(nxp, nyp, 5e3, 5e3, rdm2, dtype=dt,
                                    ytransform=t),
           (nyp, nxp))


# ---------------------------------------------------------------- d
EMF_TOL = 1e-3          # fractional mass-constraint error
# qcomp(po) against the stepped qo in float32: the Laplacian of a
# float32 pressure amplifies its rounding; 7.8e-5 measured on an H100
QCOMP_RTOL = 5e-4
F32_F64_RTOL = 1e-3     # float32 against float64 after 30 atmos steps
# Ocean pressure: a float32 run stores qo whole, on the planetary
# beta*y background (|beta y| up to 4e-5 s^-1, float32 spacing 4e-12),
# so every step rounds away digits of the dynamic PV, and the
# inversion lifts that noise into large-scale pressure. A float64 run
# whose qo alone is rounded to float32 after each step shows most of
# the gap (6.6e-3 of 7.2e-3 at 241^2 on the CPU); the solver backend
# and float64 constraint sums leave it unchanged. Measured 9.0e-3 on
# an H100 at full size, 1.12e-2 at 481^2 on the CPU; dropping the
# box mass constraint in float32 reads 0.50 (PERF.md).
F32_F64_PO_RTOL = 2e-2


def _trun_years(n_steps, dta):
    from qgcm_tpu.params import SECSYR
    return n_steps * dta / SECSYR


def phase_main_path(workdir, preset="double_gyre_coupled",
                    case="examples/double_gyre_coupled", days=2.0,
                    cmp_steps=30, grid=None):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from scipy.io import netcdf_file
    from qgcm_tpu import backend, cli, profiling
    from qgcm_tpu.config import PRESETS
    from qgcm_tpu.params import parse_input_params
    from qgcm_tpu.run import run_case
    from qgcm_tpu.ops.vorticity import qcomp

    grid = grid or {}
    grid_args = [a for k, v in grid.items() for a in (f"--{k}", str(v))]
    case = os.path.join(HERE, case)
    # the dtype `qgcm run` picks when the user names none
    cfg = PRESETS[preset](dtype=backend.default_dtype(), **grid)
    check(cfg.dtype == "float32", f"default dtype on the card is {cfg.dtype}")
    params = parse_input_params(os.path.join(case, "input.params"))
    params.trun = days / 365.0
    out = os.path.join(workdir, "dg32")
    prof = os.path.join(workdir, "profile")

    compile_s = []
    jax.monitoring.register_event_duration_secs_listener(
        lambda ev, dur, **kw: compile_s.append(dur)
        if ev == "/jax/core/compile/backend_compile_duration" else None)
    t0 = time.perf_counter()
    res = run_case(params, cfg, out, verbose=False, profile_dir=prof)
    wall = time.perf_counter() - t0
    check(not res.aborted, "run aborted on a validity failure")
    # The first chunk holds the main compile; the later ones hold every
    # cadence event, including the one-time compile of the programs
    # first called there (monit at day 1), which a user waits through.
    later = res.chunk_walls[1:]
    ms_step = 1e3 * sum(s for _, s in later) / sum(n for n, _ in later)
    ms_median = 1e3 * statistics.median(s / n for n, s in later)
    log(f"[d] {preset} {cfg.nxpo}x{cfg.nypo}x{cfg.nlo} ocean under "
        f"{cfg.nxpa}x{cfg.nypa}x{cfg.nla} atmosphere, {cfg.dtype}: "
        f"{res.steps_done} atmos steps, not aborted")
    log(f"[d] compile {sum(compile_s):.1f} s in {len(compile_s)} "
        f"programs; first chunk {res.chunk_walls[0][1]:.1f} s; "
        f"{ms_step:.3f} ms per atmos step over the {len(later)} later "
        f"chunks' whole wall (median chunk {ms_median:.3f}); run_case "
        f"wall {wall:.1f} s = {1e3 * wall / res.steps_done:.3f} ms per "
        f"atmos step with compile and set-up")
    log(f"[d] peak_bytes_in_use {peak_bytes(jax.devices()[0]) / 2**30:.2f}"
        f" GiB")

    summ = profiling.summarize(prof)
    check(summ.total_us > 0 and summ.tracks, "profile found no device ops")
    log(f"[d] profile tracks: {', '.join(summ.tracks)}")
    log(summ.report(steps=res.chunk_walls[min(2, len(res.chunk_walls) - 1)][0]))

    with netcdf_file(os.path.join(out, "monit.nc"), "r", mmap=False) as f:
        for name in ("emfroc", "emfrat"):
            worst = float(np.abs(f.variables[name][:]).max())
            log(f"[d] {name} worst {worst:.3e} (tolerance {EMF_TOL:.0e})")
            check(worst < EMF_TOL, f"{name} {worst:.3e}")

    from qgcm_tpu.model import build_model
    model = build_model(cfg)
    oc = res.ocean
    dxm2 = 1.0 / model.grids.dxo ** 2
    q = qcomp(oc.po, jnp.asarray(model.modes_oc.amat, oc.po.dtype),
              jnp.asarray(model.grids.yporel, oc.po.dtype), dxm2, cfg.fnot,
              cfg.beta, model.topo.ddynoc_or_scalar(oc.po.dtype),
              cfg.nlo - 1, cfg.cyclic_ocean)
    qi, qoi = np.asarray(q)[:, 1:-1, 1:-1], np.asarray(oc.qo)[:, 1:-1, 1:-1]
    # relative to the dynamic part of qo: the planetary beta*y term
    # alone would make any error look small
    betay = cfg.beta * np.asarray(model.grids.yporel)[None, 1:-1, None]
    err = float(np.abs(qi - qoi).max() / np.abs(qoi - betay).max())
    log(f"[d] qcomp(po) vs qo at interior points: max |diff| / "
        f"max |qo - beta y| = {err:.3e} (tolerance {QCOMP_RTOL:.0e})")
    check(err <= QCOMP_RTOL, f"qcomp {err:.3e}")

    trun = str(_trun_years(cmp_steps, cfg.dta))
    states = {}
    for dt in ("float64", "float32"):
        o = os.path.join(workdir, f"cmp_{dt}")
        argv = ["run", case, "--preset", preset, *grid_args, "--trun",
                trun, "--outdir", o, "--quiet"]
        if dt == "float64":
            argv += ["--dtype", "float64"]
        check(cli.main(argv) == 0, f"qgcm run {dt} failed")
        with netcdf_file(os.path.join(o, "lastday.nc"), "r",
                         mmap=False) as f:
            states[dt] = {k: f.variables[k][:].copy()
                          for k in ("po", "pa", "sst", "ast")}
    for k in ("po", "pa", "sst", "ast"):
        tol = F32_F64_PO_RTOL if k == "po" else F32_F64_RTOL
        err = rel_l2(states["float32"][k], states["float64"][k])
        log(f"[d] qgcm run {cmp_steps} atmos steps, {k}: float32 vs "
            f"float64 rel L2 {err:.3e} (tolerance {tol:.0e})")
        check(err <= tol, f"f32 vs f64 {k}: {err:.3e}")


# ---------------------------------------------------------------- e
def phase_largest(n_steps=4, **grid):
    import jax
    import numpy as np
    from qgcm_tpu.config import natl_1km
    from qgcm_tpu.model import build_model
    from qgcm_tpu.models.ocean import init_ocean_state, \
        ocean_forcing_from_mean
    from qgcm_tpu.models.stepper import make_ocean_only_runner
    from qgcm_tpu.generators import eddy_pressure, double_gyre_windstress

    cfg = natl_1km(ocean_only=True, dtype="float32", **grid)
    t0 = time.perf_counter()
    model = build_model(cfg)
    st = init_ocean_state(model, po=eddy_pressure(cfg, ssh_amp=0.15))
    f = ocean_forcing_from_mean(
        model, *double_gyre_windstress(cfg, model.grids))
    log(f"[e] natl_1km ocean-only {cfg.nxpo}x{cfg.nypo}x{cfg.nlo} "
        f"float32: model + state built in {time.perf_counter() - t0:.1f} s")
    run = make_ocean_only_runner(model)
    t0 = time.perf_counter()
    compiled = run.lower(st, f, n_steps=n_steps).compile()
    log(f"[e] compile {time.perf_counter() - t0:.1f} s; "
        f"memory_analysis: {compiled.memory_analysis()}")
    st = compiled(st, f)
    jax.block_until_ready(st)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        st = compiled(st, f)
        jax.block_until_ready(st)
        times.append(time.perf_counter() - t0)
    ms = 1e3 * min(times) / n_steps
    pts = cfg.nxpo * cfg.nypo * cfg.nlo
    log(f"[e] {ms:.3f} ms per ocean step (best of 3 x {n_steps} steps; "
        f"{pts / ms * 1e3:.4g} point-layer updates/s); peak_bytes_in_use "
        f"{peak_bytes(jax.devices()[0]) / 2**30:.2f} GiB")
    po = np.asarray(st.po)
    check(np.isfinite(po).all() and po.shape == (3, cfg.nypo, cfg.nxpo),
          "natl state not finite or misshapen")


# ---------------------------------------------------------------- f
def vorticity_loop(model, n_iter):
    """jit(n_iter vorticity steps of the plain jnp chain): qo/qom cycle,
    pom/po and the forcing stay fixed (timing only)."""
    import jax
    from qgcm_tpu.models.ocean import _qgostep

    def loop(st, forcing, entoc):
        def body(s, _):
            qn, qm, _ = _qgostep(model, s, forcing, entoc)
            return s._replace(qo=qn, qom=qm), None
        return jax.lax.scan(body, st, None, length=n_iter)[0]
    return jax.jit(loop)


def vorticity_inputs(cfg):
    import jax.numpy as jnp
    from qgcm_tpu.model import build_model
    from qgcm_tpu.models.ocean import init_ocean_state, \
        ocean_forcing_from_mean
    from qgcm_tpu.generators import eddy_pressure, double_gyre_windstress
    model = build_model(cfg)
    st = init_ocean_state(model, po=eddy_pressure(cfg, ssh_amp=0.15))
    f = ocean_forcing_from_mean(
        model, *double_gyre_windstress(cfg, model.grids))
    entoc = 1e-7 * jnp.ones_like(st.po[0])
    return model, st, f, entoc


def vorticity_bytes(cfg):
    """HBM bytes one step must move: read pom, po, qo, qom and the
    2-D wekpo, entoc (+ r_spl under a sponge); write qo."""
    nl, ny, nx = cfg.nlo, cfg.nypo, cfg.nxpo
    two_d = 3 if cfg.sponge.enabled else 2
    return 4 * (5 * nl * ny * nx + two_d * ny * nx)


def phase_vorticity(presets=("double_gyre_ocean_only", "natl_1km"),
                    n_iter=50, grid=None):
    import jax
    from qgcm_tpu.config import PRESETS
    from qgcm_tpu import profiling

    kind = jax.devices()[0].device_kind
    check(kind in HBM_BYTES_PER_S, f"no HBM peak for {kind!r}")
    bw = HBM_BYTES_PER_S[kind]
    for name in presets:
        cfg = PRESETS[name](ocean_only=True, dtype="float32",
                            **(grid or {}))
        model, st, f, entoc = vorticity_inputs(cfg)
        loop = vorticity_loop(model, n_iter)
        jax.block_until_ready(loop(st, f, entoc))
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(loop(st, f, entoc))
            times.append(time.perf_counter() - t0)
        ms = 1e3 * sorted(times)[2] / n_iter
        prof = tempfile.mkdtemp(prefix="vort_prof_")
        with jax.profiler.trace(prof):
            jax.block_until_ready(loop(st, f, entoc))
        dev_ms = profiling.summarize(prof).total_us / 1e3 / n_iter
        shutil.rmtree(prof, ignore_errors=True)
        bound_ms = 1e3 * vorticity_bytes(cfg) / bw
        log(f"[f] vorticity step {name} {cfg.nxpo}x{cfg.nypo}x{cfg.nlo} "
            f"f32 jnp chain: {ms:.4f} ms wall (median of 5 x {n_iter}), "
            f"{dev_ms:.4f} ms device; HBM bound "
            f"{bound_ms:.4f} ms = {bound_ms / dev_ms:.0%} of device time")


# ---------------------------------------------------------------- 4 cards
# 4-card rows mesh vs one card, per dtype. float32: the partitioned
# sums round differently, and the inversion lifts that noise in qo
# into large-scale po (as in phase d); float64 must agree to round-off.
# Readings and the reading with a halo fault are in PERF.md.
MESH_RTOL = {"float32": 1e-3, "float64": 1e-10}
ENS_RTOL = 1e-5         # float32, member mesh vs members one by one


def phase_multichip(n_steps=50, n_members=4, grid=None, ens_grid=None):
    import jax
    import numpy as np
    from qgcm_tpu.config import double_gyre_ocean_only, k247_default
    from qgcm_tpu.model import build_model
    from qgcm_tpu.models.ocean import init_ocean_state, \
        ocean_forcing_from_mean
    from qgcm_tpu.models.stepper import make_ocean_only_runner
    from qgcm_tpu.models.ensemble import (
        ensemble_mesh, make_ensemble_runner, member,
        perturbed_ocean_members, shard_members)
    from qgcm_tpu.parallel.mesh import make_mesh, shard_tree
    from qgcm_tpu.generators import eddy_pressure, double_gyre_windstress
    grid = grid or {}
    devs = jax.devices()[:4]
    mesh = make_mesh(devs, rows_only=True)

    for dtype, tol in MESH_RTOL.items():
        cfg = double_gyre_ocean_only(dtype=dtype, **grid)
        model = build_model(cfg)
        st = init_ocean_state(model, po=eddy_pressure(cfg, ssh_amp=0.15))
        f = ocean_forcing_from_mean(
            model, *double_gyre_windstress(cfg, model.grids))
        one = make_ocean_only_runner(model)(st, f, n_steps)
        run = make_ocean_only_runner(model, mesh=mesh,
                                     halo_variant="overlap",
                                     spectral_variant="a2a")
        t0 = time.perf_counter()
        many = run(shard_tree(st, mesh), shard_tree(f, mesh), n_steps)
        jax.block_until_ready(many)
        log(f"[m] dg ocean-only {cfg.nxpo}x{cfg.nypo}x{cfg.nlo} {dtype} on "
            f"a {dict(mesh.shape)} mesh (halo overlap, a2a): {n_steps} "
            f"steps, first call {time.perf_counter() - t0:.1f} s")
        log("[m] peak_bytes_in_use per card: " + ", ".join(
            f"{d.id}: {peak_bytes(d) / 2**30:.2f} GiB" for d in devs))
        check(len(many.po.sharding.device_set) == 4, "po is not on 4 cards")
        for k in ("po", "qo", "sst"):
            err = rel_l2(getattr(many, k), getattr(one, k))
            log(f"[m] {dtype} mesh vs one card, {k}: rel L2 {err:.3e} "
                f"(tolerance {tol:.0e})")
            check(err <= tol, f"{dtype} mesh {k}: {err:.3e}")

    cfg = k247_default(dtype="float32", **(ens_grid or {}))
    model = build_model(cfg)
    base = init_ocean_state(model, po=eddy_pressure(cfg))
    f = ocean_forcing_from_mean(model, *(np.zeros((cfg.nypo, cfg.nxpo)),
                                         np.zeros((cfg.nypo, cfg.nxpo)),
                                         np.zeros((cfg.nyto, cfg.nxto))))
    ms = perturbed_ocean_members(model, base, jax.random.PRNGKey(1),
                                 n_members)
    emesh = ensemble_mesh(devs)
    out = make_ensemble_runner(model, "ocean", mesh=emesh)(
        shard_members(ms, emesh), f, n_steps)
    jax.block_until_ready(out)
    check(len(out.po.sharding.device_set) == 4, "members not on 4 cards")
    run1 = make_ocean_only_runner(model)
    for i in range(n_members):
        ref = run1(member(ms, i), f, n_steps)
        err = rel_l2(member(out, i).po, ref.po)
        log(f"[m] k247 {cfg.nxpo}x{cfg.nypo}x{cfg.nlo} member {i}: member "
            f"mesh vs alone, po rel L2 {err:.3e} (tolerance {ENS_RTOL:.0e})")
        check(err <= ENS_RTOL, f"member {i}: {err:.3e}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the four-card mesh and member-mesh "
                         "checks")
    args = ap.parse_args(argv)
    import_package()
    devs = phase_device(4 if args.multichip else 1)
    if args.multichip:
        phase_multichip()
    else:
        t0 = time.perf_counter()
        phase_golden()
        with tempfile.TemporaryDirectory(prefix="qgcm_smoke_") as wd:
            phase_main_path(wd)
        phase_largest()
        phase_solver()
        phase_vorticity()
        log(f"all phases passed in {time.perf_counter() - t0:.0f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
