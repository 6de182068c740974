"""Command-line interface.

Replaces the reference's Ruby experiment workflow (exec_qgcm.rb: make
output dir, generate forcing/restart, launch job) and the standalone
k247 Fortran generators:

  qgcm run <case-dir>         -- run an experiment; the case dir holds
                                 input.params (+ optional avges.nc /
                                 restart.nc); results land in
                                 <case-dir>/outdata (exec_qgcm.rb:22-97)
  qgcm prepare <case-dir>     -- generate IC/forcing files
                                 (k247_make_{restart,forcing}_q-gcm.F90)
  qgcm analyze <outdata-dir>  -- energy/diagnostics report from
                                 monit.nc (qgcm_k247.rb checks)

Grid dimensions come from --preset (config.PRESETS) or explicit flags,
mirroring the reference's compile-time parameters_data.F presets.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _base_config(args, default_dtype=None):
    """Config from --preset / grid flags. The stepped-field dtype is
    --dtype, else `default_dtype`, else the backend's default
    (backend.default_dtype)."""
    from .backend import default_dtype as backend_dtype
    from .config import PRESETS, ModelConfig
    default_dtype = default_dtype or backend_dtype()
    if args.preset:
        cfg = PRESETS[args.preset]()
    else:
        cfg = ModelConfig(ocean_only=args.ocean_only,
                          atmos_only=args.atmos_only,
                          cyclic_ocean=args.cyclic_ocean)
    over = {}
    for k in ("nxta", "nyta", "nxaooc", "nyaooc", "ndxr"):
        v = getattr(args, k, None)
        if v is not None:
            over[k] = v
    if args.fnot is not None:
        over["fnot"] = args.fnot
    if args.beta is not None:
        over["beta"] = args.beta
    if args.dtype is not None:
        over["dtype"] = args.dtype
    if over:
        cfg = cfg.replace(**over)
    if args.ocean_only:
        cfg = cfg.replace(ocean_only=True)
    if args.atmos_only:
        cfg = cfg.replace(atmos_only=True)
    if args.dtype is None and cfg.dtype != default_dtype:
        # float32 is what production runs use on an accelerator (for
        # throughput); float64 runs there too when asked for
        from .backend import platform
        print(f"{platform()} backend: using {default_dtype} "
              "(pass --dtype float64 for double precision)")
        cfg = cfg.replace(dtype=default_dtype)
    return cfg.validate()


def cmd_run(args):
    from .params import parse_input_params, RunParams
    from .run import run_case
    from .io import read_mean_forcing, read_mean_sst
    from .backend import enable_compile_cache

    enable_compile_cache()

    case = args.case
    ppath = os.path.join(case, "input.params")
    params = parse_input_params(ppath) if os.path.exists(ppath) \
        else RunParams()
    if args.trun is not None:
        params.trun = args.trun
    # restart file path is relative to the case dir
    if params.name not in ("zero", "rbal"):
        params.name = os.path.normpath(os.path.join(case, params.name))
    cfg = _base_config(args)
    outdir = args.outdir or os.path.join(case, "outdata")
    if getattr(args, "resume", False):
        # continue the chain from the newest checkpoint of the newest
        # existing segment (the reference workflow: exec_qgcm.rb:82-87
        # links the previous run's restart.nc into the next run, one
        # outdata dir per segment, later unified by the prep tools /
        # analysis.unify_monit); tini comes from the file and trun is
        # the ADDITIONAL years to run
        def segnum(d):
            try:
                return int(os.path.basename(d).split("outdata_r")[1])
            except (IndexError, ValueError):
                return 1
        segs = [outdir] + sorted(
            (d for d in (os.path.join(case, n)
                         for n in os.listdir(case)
                         if n.startswith("outdata_r"))
             if os.path.isdir(d)), key=segnum)
        prev = segs[-1]
        cands = [os.path.join(prev, n)
                 for n in ("lastday.nc", "restart.nc",
                           "lastday_orbax", "restart_orbax")]
        cands = [c for c in cands if os.path.exists(c)]
        if not cands:
            raise SystemExit(f"--resume: no lastday.nc/restart.nc "
                             f"in {prev}")
        params.name = max(cands, key=os.path.getmtime)
        if args.outdir is None:
            # fresh segment dir so the previous outputs survive
            k = 2
            while os.path.exists(os.path.join(case, f"outdata_r{k}")):
                k += 1
            outdir = os.path.join(case, f"outdata_r{k}")
        elif os.path.realpath(outdir) == os.path.realpath(prev):
            # the Driver's writers would truncate the very monit/
            # avges files of the segment being resumed from
            raise SystemExit(
                f"--resume: --outdir {outdir} is the segment being "
                f"resumed from; pick a fresh directory (or omit "
                f"--outdir for automatic outdata_rK segments)")
        print(f"resuming from {params.name} -> {outdir}")

    mean_forcing = None
    sst_mean = None
    avpath = os.path.join(case, "avges.nc")
    if cfg.ocean_only:
        if os.path.exists(avpath):
            mean_forcing = read_mean_forcing(avpath)
        else:
            from .generators import zero_forcing
            print("no avges.nc in case dir; using zero mean forcing")
            mean_forcing = zero_forcing(cfg)
    if cfg.atmos_only:
        sst_mean = read_mean_sst(avpath)

    mesh = None
    if args.mesh:
        import jax
        from .parallel.mesh import make_mesh, make_hybrid_mesh
        if args.mesh == "hybrid":
            mesh = make_hybrid_mesh(rows_only=cfg.cyclic_ocean)
        elif args.mesh == "rows":
            mesh = make_mesh(rows_only=True)
        elif args.mesh == "auto":
            # rows-only for every config: the fewest spectral a2a
            # rounds -- channels additionally NEED x unsharded for the
            # cyclic wraparound (make_mesh docstring). Box oceans keep
            # the explicit halo schedule on x>1 meshes too (2-D
            # decomposition, parallel/halo.py).
            mesh = make_mesh(rows_only=True)
        else:
            import numpy as np
            from jax.sharding import Mesh
            ny, nx = (int(v) for v in args.mesh.split("x"))
            mesh = Mesh(np.asarray(jax.devices()[: ny * nx])
                        .reshape(ny, nx), ("y", "x"))
        print(f"mesh: {dict(mesh.shape)} over {mesh.devices.size} "
              "devices (a2a spectral solvers)")

    res = run_case(params, cfg, outdir, sst_mean=sst_mean,
                   mean_forcing=mean_forcing, verbose=not args.quiet,
                   qoc_diag=args.qoc_diag, ocavg_days=args.ocavg_days,
                   profile_dir=args.profile, mesh=mesh,
                   cadence_rounding="exact" if args.exact_cadences
                   else "cycles", ckpt_format=args.ckpt_format,
                   avges_sampling=args.avges_sampling)
    print(f"done: {res.steps_done} steps, t={res.tyrs:.4f} years"
          + (" [ABORTED ON VALIDITY FAILURE]" if res.aborted else ""))
    return 1 if res.aborted else 0


def cmd_prepare(args):
    """Generate restart.nc (analytic eddy IC) and/or avges.nc (mean
    forcing) into the case dir."""
    # IC/forcing generation is host-side float64 work: build on the
    # CPU device, without pinning the process's platform
    import jax
    with jax.default_device(jax.devices("cpu")[0]):
        return _prepare(args)


def _prepare(args):
    from .model import build_model
    from .generators import (eddy_pressure, zero_forcing,
                             double_gyre_windstress)
    from .models.ocean import init_ocean_state
    from .models.atmos import init_atmos_state
    from .io import save_restart
    from .io.forcing import write_mean_forcing
    from .params import parse_input_params, params_to_config

    cfg = _base_config(args, default_dtype="float64")
    # layer counts/physics must match the case's input.params
    ppath = os.path.join(args.case, "input.params")
    if os.path.exists(ppath):
        cfg = params_to_config(parse_input_params(ppath), cfg)
    model = build_model(cfg)
    os.makedirs(args.case, exist_ok=True)

    if args.modon:
        from .generators import modon_pressure
        rdef = float(model.modes_oc.rdef[1])
        po = modon_pressure(cfg, rdef)
        oc = init_ocean_state(model, po=po)
    elif args.eddy_amp is not None:
        po = eddy_pressure(cfg, ssh_amp=args.eddy_amp,
                           l_efold=args.eddy_scale)
        oc = init_ocean_state(model, po=po)
    else:
        oc = init_ocean_state(model, init="rbal")
    at = init_atmos_state(model, init="rbal")
    save_restart(os.path.join(args.case, "restart.nc"), model, oc, at,
                 0.0)
    print(f"wrote {args.case}/restart.nc")

    if args.forcing == "zero":
        f = zero_forcing(cfg)
    elif args.forcing == "channel":
        from .generators import channel_windstress
        f = channel_windstress(cfg, model.grids, tau0=args.tau0)
    else:
        f = double_gyre_windstress(cfg, model.grids, tau0=args.tau0)
    write_mean_forcing(os.path.join(args.case, "avges.nc"), model, *f)
    print(f"wrote {args.case}/avges.nc")
    return 0


def cmd_ensemble(args):
    """Perturbed-IC ensemble run (models/ensemble.py, beyond the
    reference: it runs one trajectory per job): members ride a vmapped
    batch axis of one jitted program, optionally sharded over all
    devices with zero collectives; writes the spread time series to
    ensemble.nc in the case's outdata_ens directory."""
    import jax
    from .model import build_model
    from .models.ocean import (init_ocean_state,
                               ocean_forcing_from_mean)
    from .backend import enable_compile_cache
    enable_compile_cache()
    from .models.atmos import init_atmos_state
    from .models.ensemble import (perturbed_ocean_members,
                                  perturbed_atmos_members,
                                  make_ensemble_runner, ensemble_mesh,
                                  spread_rms)
    from .io import read_mean_forcing
    from .io.restart import load_restart
    from .io.ncdf import NcWriter
    from .params import parse_input_params, params_to_config, RunParams

    case = args.case
    ppath = os.path.join(case, "input.params")
    params = parse_input_params(ppath) if os.path.exists(ppath) \
        else RunParams()
    if params.name not in ("zero", "rbal"):
        params.name = os.path.normpath(os.path.join(case, params.name))
    cfg = params_to_config(params, _base_config(args))
    if cfg.atmos_only:
        raise SystemExit("qgcm ensemble supports ocean-only and "
                         "coupled configurations")
    model = build_model(cfg)
    outdir = args.outdir or os.path.join(case, "outdata_ens")
    os.makedirs(outdir, exist_ok=True)

    tini = 0.0
    at0 = None
    if params.name in ("zero", "rbal"):
        oc0 = init_ocean_state(model, init=params.name)
        if not cfg.ocean_only:
            at0 = init_atmos_state(model, init=params.name)
    elif os.path.isdir(params.name):
        # Orbax checkpoint directory (same dispatch as the Driver,
        # run.py _initial_state)
        from .io.orbax_ckpt import load_checkpoint
        oc0, at0, tini = load_checkpoint(
            os.path.abspath(params.name), model)
    else:
        oc0, at0, tini = load_restart(params.name, model)

    m = args.members
    koc, kat = jax.random.split(jax.random.PRNGKey(args.seed))
    ocm = perturbed_ocean_members(model, oc0, koc, m, amp=args.amp)
    kind = "ocean" if cfg.ocean_only else "coupled"
    atm = None
    if kind == "coupled":
        atm = perturbed_atmos_members(model, at0, kat, m,
                                      amp=10.0 * args.amp)
    mesh = None
    if args.shard_members:
        import math
        ndev = len(jax.devices())
        nd = math.gcd(m, ndev)
        if nd == 1 and ndev > 1:
            raise SystemExit(
                f"--shard-members: {m} members share no factor with "
                f"{ndev} devices -- pick a member count that is a "
                f"multiple of the device count")
        if nd < ndev:
            print(f"warning: {m} members is not a multiple of {ndev} "
                  f"devices; sharding over only {nd} device(s)")
        mesh = ensemble_mesh(jax.devices()[:nd])
        print(f"sharding {m} members over {nd} device(s)")
    run = make_ensemble_runner(model, kind=kind, mesh=mesh)

    forcing = None
    if cfg.ocean_only:
        avpath = os.path.join(case, "avges.nc")
        if os.path.exists(avpath):
            arrays = read_mean_forcing(avpath)
        else:
            from .generators import zero_forcing
            print("no avges.nc in case dir; using zero mean forcing")
            arrays = zero_forcing(cfg)
        forcing = ocean_forcing_from_mean(model, *arrays)

    day = 86400.0
    # bookkeeping in the runner's own step unit: ocean substeps (dto)
    # for ocean-only, atmos steps (dta) for coupled (which must
    # advance in whole coupling cycles)
    dt = cfg.nstr * cfg.dta if cfg.ocean_only else cfg.dta
    quantum = 1 if cfg.ocean_only else cfg.nstr
    sample = max(quantum,
                 round(args.sample_days * day / dt / quantum)
                 * quantum)
    # run length rounds to whole sampling intervals: a shorter final
    # chunk would change the jit-static n_steps and force a second
    # full compile of the ensemble program for one short segment
    total = max(sample, round(args.days * day / dt / sample) * sample)

    w = NcWriter(os.path.join(outdir, "ensemble.nc"))
    w.dim("time", None)
    w.dim("member", m)
    w.var("tyrs", "d", ("time",), units="years")
    w.var("spread_po", "d", ("time",), units="m^2/s^2",
          long_name="RMS ensemble spread of ocean pressure")
    w.var("spread_sst", "d", ("time",), units="K",
          long_name="RMS ensemble spread of SST")
    w.var("po_rms", "d", ("time", "member"), units="m^2/s^2",
          long_name="per-member RMS ocean pressure")
    if kind == "coupled":
        w.var("spread_pa", "d", ("time",), units="m^2/s^2",
              long_name="RMS ensemble spread of atmos pressure")

    import jax.numpy as jnp

    def record(rec, n_done):
        t = tini + n_done * dt / (day * 365.0)
        sp = spread_rms(ocm, "po")
        sst_sp = spread_rms(ocm, "sst")
        w.append("tyrs", rec, t)
        w.append("spread_po", rec, sp)
        w.append("spread_sst", rec, sst_sp)
        # per-member RMS reduced on device; one (m,) vector fetched
        w.append("po_rms", rec, np.asarray(jnp.sqrt(
            jnp.mean(jnp.square(ocm.po), axis=(1, 2, 3)))))
        if atm is not None:
            w.append("spread_pa", rec, spread_rms(atm, "pa"))
        if not args.quiet:
            print(f"t={t:9.5f}y  spread_po={sp:.3e}  "
                  f"spread_sst={sst_sp:.3e}")
        w.flush()

    record(0, 0)
    n_done, rec = 0, 1
    while n_done < total:
        n = min(sample, total - n_done)
        if kind == "ocean":
            ocm = run(ocm, forcing, n, n_done)
        else:
            ocm, atm = run(ocm, atm, n, n_done)
        ocm = jax.block_until_ready(ocm)
        n_done += n
        record(rec, n_done)
        rec += 1
    w.close()
    print(f"wrote {outdir}/ensemble.nc ({rec} records, {m} members)")
    return 0


def cmd_sense(args):
    """Adjoint sensitivity of a scalar objective to the mean forcing
    and initial condition (adjoint.py; docs/adjoint.md -- no reference
    analogue). Ocean-only cases: loads the case's IC and avges.nc
    forcing, runs `--days` of physics, differentiates the objective
    through the whole run and writes the gradient fields to
    sensitivity.nc in the case's outdata directory."""
    import jax
    import numpy as np
    from .model import build_model
    from .models.ocean import init_ocean_state
    from .io import read_mean_forcing
    from .io.restart import load_restart
    from .io.ncdf import make_writer as NcWriter
    from .params import parse_input_params, params_to_config, \
        RunParams, SECDAY
    from .adjoint import (ocean_sensitivity, layer1_energy_proxy,
                          transport_proxy)
    from .backend import enable_compile_cache
    enable_compile_cache()

    case = args.case
    ppath = os.path.join(case, "input.params")
    params = parse_input_params(ppath) if os.path.exists(ppath) \
        else RunParams()
    if params.name not in ("zero", "rbal"):
        params.name = os.path.normpath(os.path.join(case, params.name))
    cfg = params_to_config(params, _base_config(args))
    if not cfg.ocean_only:
        raise SystemExit("qgcm sense supports ocean-only cases "
                         "(coupled adjoints: models/stepper "
                         "make_coupled_runner(remat=True) + jax.grad)")
    model = build_model(cfg)

    if params.name in ("zero", "rbal"):
        oc0 = init_ocean_state(model, init=params.name)
    else:
        oc0, _, _ = load_restart(params.name, model)

    avpath = os.path.join(case, "avges.nc")
    if os.path.exists(avpath):
        mf = read_mean_forcing(avpath)
    else:
        from .generators import zero_forcing
        print("no avges.nc in case dir; using zero mean forcing")
        mf = zero_forcing(cfg)

    n_steps = max(1, round(args.days * SECDAY / cfg.dto))
    obj = (transport_proxy(model) if args.objective == "transport"
           else layer1_energy_proxy(model))
    print(f"objective={args.objective}, horizon {args.days} d = "
          f"{n_steps} ocean steps, remat={args.remat}")
    remat = {"true": True, "dots": "dots", "false": False}.get(
        args.remat)
    if remat is None:
        # integer = per-level fan-out of the nested checkpointed scan
        # (memory ~ levels * N carries; stepper.REMAT_LEVEL default)
        remat = int(args.remat)
    seg = 0
    if args.segment_days:
        seg = max(1, round(args.segment_days * SECDAY / cfg.dto))
        if n_steps % seg:
            raise SystemExit(
                f"--segment-days: {args.days} days is not a multiple "
                f"of {args.segment_days}-day segments")
        print(f"host-level segments of {seg} steps "
              f"({n_steps // seg} segments)")
    sens = ocean_sensitivity(model, obj, remat=remat,
                             segment_steps=seg)
    val, g = sens(oc0, mf, n_steps)

    outdir = args.outdir or os.path.join(case, "outdata")
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "sensitivity.nc")
    w = NcWriter(path)
    w.dim("xpo", cfg.nxpo); w.dim("ypo", cfg.nypo)
    w.dim("xto", cfg.nxto); w.dim("yto", cfg.nyto)
    w.dim("zo", cfg.nlo)
    w.var("objective", "d", (), data=float(val))
    w.var("dJ_dtauxo", "d", ("ypo", "xpo"),
          data=np.asarray(g.forcing[0], np.float64))
    w.var("dJ_dtauyo", "d", ("ypo", "xpo"),
          data=np.asarray(g.forcing[1], np.float64))
    w.var("dJ_dfnetoc", "d", ("yto", "xto"),
          data=np.asarray(g.forcing[2], np.float64))
    w.var("dJ_dpo", "d", ("zo", "ypo", "xpo"),
          data=np.asarray(g.state0.po, np.float64))
    w.var("dJ_dsst", "d", ("yto", "xto"),
          data=np.asarray(g.state0.sst, np.float64))
    w.close()
    gx = np.asarray(g.forcing[0])
    print(f"objective value: {float(val):.6e}")
    print(f"dJ/dtauxo: rms {float(np.sqrt(np.mean(gx**2))):.3e}, "
          f"|max| {float(np.abs(gx).max()):.3e}")
    print(f"wrote {path}")
    return 0


def cmd_analyze(args):
    """Energy/diagnostics summary from monit.nc (the checks the Ruby
    layer runs: KE/PE series, constraint errors, CFL), plus the
    derived-product files monit_energy.nc and sshmax_etc.nc.
    --chain first unifies the monit series of a --resume segment
    chain (outdata, outdata_r2, ...) into <case>/outdata_unified/
    (the Ruby prep workflow, qgcm_prep_k247.rb:5-12)."""
    from scipy.io import netcdf_file
    enspath = os.path.join(args.outdata, "ensemble.nc")
    if os.path.exists(enspath) and not os.path.exists(
            os.path.join(args.outdata, "monit.nc")):
        # a `qgcm ensemble` output directory: summarize the spread
        # series (growth rate via a log-linear fit over the growing
        # part of the curve -> e-folding/doubling time)
        f = netcdf_file(enspath, mmap=False)
        tyrs = np.asarray(f.variables["tyrs"][:], dtype=float)
        sp = np.asarray(f.variables["spread_po"][:], dtype=float)
        nm = f.dimensions["member"]
        f.close()
        print(f"ensemble.nc: {nm} members, {len(tyrs)} records, "
              f"{(tyrs[-1] - tyrs[0]) * 365.0:.2f} days")
        print(f"spread_po: {sp[0]:.3e} -> {sp[-1]:.3e} m^2/s^2")
        # fit the growth rate over the pre-saturation segment only:
        # records past ~70% of the peak spread sit on the plateau and
        # bias the fitted e-folding time long
        onset = np.nonzero(sp >= 0.7 * sp.max())[0]
        end = max(int(onset[0]) if len(onset) else len(sp), 3)
        seg = (sp[:end] > 0)
        if seg.sum() >= 3 and sp[-1] > sp[0] > 0:
            days = (tyrs[:end][seg] - tyrs[0]) * 365.0
            rate = np.polyfit(days, np.log(sp[:end][seg]), 1)[0]
            if rate > 0:
                print(f"e-folding time {1.0 / rate:.2f} days "
                      f"(doubling {np.log(2.0) / rate:.2f} days, "
                      f"fit over the first {end} records)")
        return 0
    if getattr(args, "chain", False):
        import shutil
        from .analysis import unify_monit
        first = os.path.abspath(args.outdata)
        case = os.path.dirname(first)

        def segnum(d):
            try:
                return int(os.path.basename(d).split("outdata_r")[1])
            except (IndexError, ValueError):
                return 1
        segs = [first] + sorted(
            (os.path.join(case, n) for n in os.listdir(case)
             if n.startswith("outdata_r")
             and os.path.isdir(os.path.join(case, n))), key=segnum)
        skipped = [s for s in segs if not
                   os.path.exists(os.path.join(s, "monit.nc"))]
        segs = [s for s in segs if s not in skipped]
        for s in skipped:
            print(f"(skipping {s}: no monit.nc -- monitoring was "
                  f"off for that segment)")
        if not segs:
            raise SystemExit("--chain: no segment has a monit.nc")
        uni = os.path.join(case, "outdata_unified")
        os.makedirs(uni, exist_ok=True)
        unify_monit(segs, os.path.join(uni, "monit.nc"))
        pm = os.path.join(segs[-1], "input_parameters.m")
        if os.path.exists(pm):
            shutil.copy(pm, uni)
        print(f"unified {len(segs)} segments -> {uni}/monit.nc")
        args.outdata = uni
    try:
        from .analysis import QgcmData
        qd = QgcmData(args.outdata)
        print("wrote", qd.write_energy())
        if os.path.exists(os.path.join(args.outdata, "ocpo.nc")):
            print("wrote", qd.write_sshmax())
        qd.energy_check(verbose=True)
    except Exception as e:
        print(f"(derived products skipped: {e})")

    path = os.path.join(args.outdata, "monit.nc")
    with netcdf_file(path, "r", mmap=False) as f:
        t = f.variables["time"][:].copy()
        print(f"monit.nc: {len(t)} records, t = {t[0]:.4f}.."
              f"{t[-1]:.4f} years")

        def series(name):
            return (f.variables[name][:].copy()
                    if name in f.variables else None)

        for fluid, kname in (("ocean", "kealoc"), ("atmos", "kealat")):
            ke = series(kname)
            if ke is None:
                continue
            print(f"\n{fluid}: KE per layer (J/m^2)")
            print("  first:", np.array2string(ke[0], precision=4))
            print("  last: ", np.array2string(ke[-1], precision=4))
        for name in ("utauoc", "btdgoc", "pkenoc", "utauat", "olrtop",
                     "cnqgoc", "cnqgat", "cnmlat"):
            s = series(name)
            if s is not None:
                print(f"{name}: mean={s.mean():.4e} last={s[-1]:.4e}")
        for name in ("emfroc", "emfrat"):
            s = series(name)
            if s is not None:
                worst = np.abs(s).max()
                print(f"{name}: worst fractional error = {worst:.2e}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="qgcm")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add_grid(p):
        p.add_argument("--preset", choices=[
            "double_gyre_ocean_only", "double_gyre_coupled",
            "southern_ocean_ocean_only", "southern_ocean_coupled",
            "k247_default", "natl_1km"])
        for k in ("nxta", "nyta", "nxaooc", "nyaooc", "ndxr"):
            p.add_argument(f"--{k}", type=int)
        p.add_argument("--fnot", type=float)
        p.add_argument("--beta", type=float)
        p.add_argument("--dtype", choices=["float32", "float64"])
        p.add_argument("--ocean-only", action="store_true",
                       dest="ocean_only")
        p.add_argument("--atmos-only", action="store_true",
                       dest="atmos_only")
        p.add_argument("--cyclic-ocean", action="store_true",
                       dest="cyclic_ocean")

    pr = sub.add_parser("run", help="run an experiment case")
    pr.add_argument("case")
    pr.add_argument("--outdir")
    pr.add_argument("--trun", type=float,
                    help="override run length (years)")
    pr.add_argument("--resume", action="store_true",
                    help="continue from the newest checkpoint in the "
                    "case's outdata (lastday.nc/restart.nc) instead "
                    "of the input.params initial state -- the "
                    "reference's restart-chaining workflow "
                    "(exec_qgcm.rb:82-87)")
    pr.add_argument("--quiet", action="store_true")
    pr.add_argument("--qoc-diag", action="store_true", dest="qoc_diag",
                    help="write the dq/dt decomposition (qocdiag.nc)")
    pr.add_argument("--ocavg-days", type=float, default=0.0,
                    dest="ocavg_days",
                    help="k247 ocean-average stream interval (days)")
    pr.add_argument("--mesh", default=None, metavar="auto|rows|hybrid|NYxNX",
                    help="run on a device mesh: 'auto'/'rows' "
                         "(y-only decomposition -- the measured-best "
                         "production layout), 'hybrid' (multi-host: "
                         "hosts on y, local chips on x), or an "
                         "explicit NYxNX shape. Box oceans keep the "
                         "explicit halo schedule + Pallas kernel on "
                         "every shape (2-D decomposition when x>1); "
                         "cyclic channels are rows-only and fall "
                         "back to GSPMD stencils when x>1, with a "
                         "warning")
    pr.add_argument("--ckpt-format", choices=["netcdf", "orbax"],
                    default="netcdf", dest="ckpt_format",
                    help="checkpoint format: 'netcdf' = the "
                    "reference's restart.nc schema (gathered to one "
                    "host); 'orbax' = sharded checkpoint directories "
                    "where each process writes its own shards (the "
                    "at-scale multi-host path)")
    pr.add_argument("--avges-sampling", choices=["mean", "midpoint"],
                    default="mean", dest="avges_sampling",
                    help="avges.nc accumulation: 'mean' (default) = "
                    "true time means over every step; 'midpoint' = "
                    "the reference's one-sample-per-interval midpoint "
                    "subsampling (q-gcm.F:1477-1482), for bit-"
                    "comparable avges output")
    pr.add_argument("--exact-cadences", action="store_true",
                    dest="exact_cadences",
                    help="honour cadences at any whole atmospheric "
                    "step instead of the reference's rounding to "
                    "whole coupling cycles (q-gcm.F:656-698)")
    pr.add_argument("--profile", metavar="DIR", default=None,
                    help="trace a steady-state chunk with jax.profiler"
                         " into DIR and print a per-kernel device-time"
                         " report")
    add_grid(pr)
    pr.set_defaults(fn=cmd_run)

    pp = sub.add_parser("prepare", help="generate IC/forcing files")
    pp.add_argument("case")
    icgrp = pp.add_mutually_exclusive_group()
    icgrp.add_argument("--eddy-amp", type=float, default=None,
                       help="Gaussian eddy SSH amplitude (m)")
    icgrp.add_argument("--modon", action="store_true",
                       help="Larichev-Reznik modon initial condition")
    pp.add_argument("--eddy-scale", type=float, default=80.0e3)
    pp.add_argument("--forcing",
                    choices=["zero", "double-gyre", "channel"],
                    default="zero")
    pp.add_argument("--tau0", type=float, default=2.0e-5)
    add_grid(pp)
    pp.set_defaults(fn=cmd_prepare)

    pe = sub.add_parser("ensemble",
                        help="perturbed-IC ensemble (predictability) "
                             "run; writes a spread series to "
                             "ensemble.nc")
    pe.add_argument("case")
    pe.add_argument("--members", type=int, default=8)
    pe.add_argument("--amp", type=float, default=1e-3,
                    help="RMS ocean pressure perturbation (m^2 s^-2; "
                         "~0.1 per cm of SSH at mid-latitude f0)")
    pe.add_argument("--seed", type=int, default=0)
    pe.add_argument("--days", type=float, default=10.0,
                    help="run length (days)")
    pe.add_argument("--sample-days", type=float, default=1.0,
                    dest="sample_days",
                    help="spread-series sampling interval (days)")
    pe.add_argument("--shard-members", action="store_true",
                    dest="shard_members",
                    help="shard the member axis over all devices via "
                         "shard_map (members must be a multiple of "
                         "the device count; the compiled program has "
                         "zero collectives)")
    pe.add_argument("--outdir")
    pe.add_argument("--quiet", action="store_true")
    add_grid(pe)
    pe.set_defaults(fn=cmd_ensemble)

    ps = sub.add_parser("sense",
                        help="adjoint sensitivity of an objective to "
                        "forcing/IC (writes sensitivity.nc)")
    ps.add_argument("case")
    ps.add_argument("--objective", choices=["energy", "transport"],
                    default="energy",
                    help="scalar objective of the final state: "
                    "'energy' = layer-1 KE density; 'transport' = "
                    "zonal-mean layer-1 zonal transport (channels)")
    ps.add_argument("--days", type=float, default=10.0,
                    help="sensitivity horizon in model days")
    ps.add_argument("--remat", default="true",
                    help="backward-pass memory policy: true | dots | "
                    "false | an integer nested-scan fan-out "
                    "(docs/adjoint.md)")
    ps.add_argument("--segment-days", type=float, default=0.0,
                    dest="segment_days",
                    help="host-level checkpointing: chain exact "
                    "per-segment VJPs of this many days each, for "
                    "horizons whose one-program backward exceeds "
                    "HBM (must divide --days)")
    ps.add_argument("--outdir")
    add_grid(ps)
    ps.set_defaults(fn=cmd_sense)

    pa = sub.add_parser("analyze", help="summarise a run's monit.nc")
    pa.add_argument("outdata")
    pa.add_argument("--chain", action="store_true",
                    help="unify a --resume segment chain (outdata, "
                    "outdata_r2, ...) into <case>/outdata_unified "
                    "first, then analyze the unified series")
    pa.set_defaults(fn=cmd_analyze)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
