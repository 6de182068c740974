"""input.params parser, matlab dump, and driver workflow tests."""

import os

import numpy as np
import pytest

from qgcm_tpu.params import (parse_input_params, params_to_config,
                             write_matlab_params, RunParams)
from qgcm_tpu.config import ModelConfig, k247_default

REF_PARAMS = "/root/reference/src/input.params"


@pytest.mark.skipif(not os.path.exists(REF_PARAMS),
                    reason="reference tree not mounted")
def test_parse_reference_input_params():
    """Drop-in compatibility: the reference's own input.params parses
    with the documented values (src/input.params active lines)."""
    p = parse_input_params(REF_PARAMS)
    assert p.trun == pytest.approx(0.054794521)
    assert p.dta == 144.0
    assert p.nstr == 3
    assert p.dxo == 4.0e3
    assert p.delek == 0.0
    assert p.bccooc == 0.2
    assert p.zopt == (2.0e4, 2.0e4, 3.0e4)
    assert p.hoc == (800.0, 3.2e20)
    assert p.gpoc == (0.01,)
    assert p.hat == (2000.0, 3000.0, 4000.0)
    assert p.name == "./restart.nc"
    assert p.topocname == "flat"
    assert p.outfloc == (1, 1, 0, 1, 0, 0, 0)
    assert p.outflat == (1, 1, 1, 1, 1, 1, 1)


@pytest.mark.skipif(not os.path.exists(REF_PARAMS),
                    reason="reference tree not mounted")
def test_params_to_config_matches_k247():
    p = parse_input_params(REF_PARAMS)
    base = k247_default()
    cfg = params_to_config(p, base)
    assert cfg.nlo == 2
    assert cfg.ocean.dxo == 4.0e3
    assert cfg.dto == 432.0
    assert cfg.ocean.gpoc == (0.01,)


def test_matlab_dump_roundtrip(tmp_path):
    p = RunParams()
    cfg = ModelConfig(nxta=24, nyta=12, nxaooc=8, nyaooc=8,
                      ndxr=2).validate()
    path = str(tmp_path / "input_parameters.m")
    write_matlab_params(path, p, cfg)
    text = open(path).read()
    vals = {}
    for line in text.strip().splitlines():
        name, rhs = line.split("=", 1)
        rhs = rhs.strip().rstrip(";")
        if rhs.startswith("'"):
            vals[name.strip()] = rhs.strip("'")
        elif rhs.startswith("["):
            vals[name.strip()] = [float(x) for x in rhs[1:-1].split()]
        else:
            vals[name.strip()] = float(rhs)
    assert vals["dta"] == p.dta
    assert vals["nxta"] == cfg.nxta
    assert vals["hoc"] == list(p.hoc)
    assert vals["dto"] == cfg.dto
    assert vals["name"] == "zero"
    assert vals["cyclicoc"] == 0.0 and vals["oceanonly"] == 0.0
    assert vals["nmcvoc"] == vals["nvcvoc"] * (vals["nvcvoc"] + 1) / 2


def test_matlab_dump_complete_manifest(tmp_path):
    """The dump covers every distinct name of the reference's
    out_param.f (118 assignments; vector appends collapse to one
    entry each), plus derived values only available with a model."""
    from qgcm_tpu.config import double_gyre_coupled, OceanConfig
    from qgcm_tpu.model import build_model
    base = double_gyre_coupled(nxta=24, nyta=12, nxaooc=8, nyaooc=8,
                               ndxr=4, ocean=OceanConfig(dxo=20.0e3))
    p = RunParams(dta=180.0, nstr=3, dxo=20.0e3)
    model = build_model(base)
    path = str(tmp_path / "input_parameters.m")
    write_matlab_params(path, p, base, model, tini=1.5)
    names = {ln.split("=", 1)[0].strip()
             for ln in open(path) if "=" in ln}
    # the reference's distinct names (out_param.f), 'prtday' and the
    # covariance cadences are ours; nsteps0/nsteps are step counts the
    # scan driver derives on the fly
    manifest = [
        "oceanonly", "atmosonly", "getcovar", "cyclicoc", "hflxsb",
        "hflxnb", "tauudiff", "nxto", "nyto", "nlo", "nxta", "nyta",
        "nla", "nxaooc", "nyaooc", "ndxr", "nx1", "ny1", "fnot",
        "beta", "nscvoc", "nvcvoc", "nmcvoc", "nscvat", "nvcvat",
        "nmcvat", "tini", "trun", "tend", "dto", "dta", "dxo", "dxa",
        "delek", "cdat", "rhoat", "rhooc", "cpat", "cpoc", "bccoat",
        "bccooc", "xcexp", "ycexp", "valday", "odiday", "adiday",
        "dgnday", "resday", "nsko", "nska", "dtavat", "dtavoc",
        "hmoc", "hmat", "st2d", "st4d", "ahmd", "at2d", "at4d",
        "tsbdy", "xlamda", "hmadmp", "fsbar", "fspamp", "zm", "zopt",
        "gamma", "gpoc", "ah2oc", "ah4oc", "tabsoc", "tocc", "hoc",
        "gpat", "ah4at", "tabsat", "tat", "hat", "name", "outfloc",
        "outflat", "tmbara", "tmbaro", "cphsoc", "rdefoc", "tnbdy",
        "cphsat", "rdefat", "aface", "bface", "cface", "dface",
        "l_spl", "c1_spl", "noutoc", "noutat"]
    missing = [n for n in manifest if n not in names]
    assert not missing, missing


def test_driver_mesh_default_halo_variant(tmp_path):
    """Mesh-run default: the Driver picks the 'overlap' shard_map halo
    schedule on any mesh (fewer collectives/step than GSPMD auto,
    test_halo; x>1 box meshes take the 2-D decomposition). CYCLIC channels are rows-only by design: x>1
    falls back to GSPMD with a LOUD warning. None forces GSPMD."""
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from qgcm_tpu.config import ModelConfig
    from qgcm_tpu.model import build_model
    from qgcm_tpu.run import Driver
    if len(jax.devices()) < 4:
        import pytest as _pt
        _pt.skip("needs multi-device CPU mesh")
    base = ModelConfig(nxta=24, nyta=24, nxaooc=24, nyaooc=12, ndxr=2,
                       fnot=5.92e-5, beta=2.08e-11,
                       ocean_only=True, cyclic_ocean=True)
    model = build_model(base.validate())
    p = RunParams(trun=1.0 / 365.0, dta=150.0, nstr=3, valday=0.0,
                  odiday=0.0, adiday=0.0, dgnday=0.0, prtday=0.0,
                  resday=0.0, dtavoc=0.0, dtavat=0.0)
    rows = Mesh(np.asarray(jax.devices()[:4]).reshape(4, 1),
                ("y", "x"))
    two_d = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                 ("y", "x"))
    d = Driver(model, p, str(tmp_path / "a"), mean_forcing=None,
               verbose=False, mesh=rows)
    assert d.halo_variant == "overlap"
    # CYCLIC + x>1 loses the explicit schedule: the fallback must be
    # LOUD, steering users to rows-only meshes
    with pytest.warns(UserWarning, match="rows only"):
        d2 = Driver(model, p, str(tmp_path / "b"), mean_forcing=None,
                    verbose=False, mesh=two_d)
    assert d2.halo_variant is None
    d3 = Driver(model, p, str(tmp_path / "c"), mean_forcing=None,
                verbose=False, mesh=rows, halo_variant=None)
    assert d3.halo_variant is None
    # BOX oceans keep the explicit schedule on 2-D meshes (the 2-D
    # halo decomposition, parallel/halo.py): no warning, no fallback
    box = ModelConfig(nxta=24, nyta=24, nxaooc=24, nyaooc=12, ndxr=2,
                      fnot=5.92e-5, beta=2.08e-11,
                      ocean_only=True, cyclic_ocean=False)
    model_box = build_model(box.validate())
    import warnings as _w
    with _w.catch_warnings():
        _w.simplefilter("error")
        d4 = Driver(model_box, p, str(tmp_path / "d"),
                    mean_forcing=None, verbose=False, mesh=two_d)
    assert d4.halo_variant == "overlap"


def test_driver_ocean_only(tmp_path):
    """Short ocean-only driver run: completes, writes the output file
    set, conserves the unforced eddy's layer-1 KE."""
    from qgcm_tpu.config import ModelConfig, OceanConfig
    from qgcm_tpu.run import run_case
    from qgcm_tpu.generators import eddy_pressure, zero_forcing
    from qgcm_tpu.model import build_model
    from qgcm_tpu.models.ocean import init_ocean_state
    from qgcm_tpu.io import save_restart
    from qgcm_tpu.models.atmos import init_atmos_state

    base = ModelConfig(nxta=24, nyta=24, nxaooc=24, nyaooc=12, ndxr=2,
                       fnot=5.92e-5, beta=2.08e-11,
                       ocean_only=True, cyclic_ocean=True)
    p = RunParams(trun=1.0 / 365.0, dta=150.0, nstr=3, dxo=20.0e3,
                  delek=0.0, valday=0.125, odiday=0.5, adiday=0.0,
                  dgnday=0.25, prtday=0.0, resday=0.5, dtavoc=0.5,
                  dtavat=0.0,
                  ah2oc=(0.0, 0.0), ah4oc=(0.0, 0.0),
                  tabsoc=(287.0, 282.0), hoc=(800.0, 3.2e20),
                  gpoc=(0.01,), name="zero")
    # build a restart with an eddy so the run is non-trivial
    cfg = params_to_config(p, base)
    model = build_model(cfg)
    oc = init_ocean_state(model, po=eddy_pressure(cfg))
    at = init_atmos_state(model, init="rbal")
    rst = str(tmp_path / "restart_in.nc")
    save_restart(rst, model, oc, at, 0.0)
    p.name = rst

    res = run_case(p, base, str(tmp_path / "out"),
                   mean_forcing=zero_forcing(cfg), verbose=False)
    assert not res.aborted
    assert res.steps_done == round(p.trun * 365 * 86400 / p.dta)
    for f in ("monit.nc", "ocpo.nc", "ocsst.nc", "avges.nc",
              "lastday.nc", "restart.nc", "input_parameters.m"):
        assert (tmp_path / "out" / f).exists(), f

    from scipy.io import netcdf_file
    with netcdf_file(str(tmp_path / "out" / "monit.nc"), "r",
                     mmap=False) as f:
        ke = f.variables["kealoc"][:]
        assert np.isfinite(ke).all()
        # unforced inviscid eddy: KE drift small over 1 day
        assert abs(ke[-1, 0] - ke[0, 0]) < 0.02 * ke[0, 0]
    with netcdf_file(str(tmp_path / "out" / "avges.nc"), "r",
                     mmap=False) as f:
        assert f.variables["po"].shape == (cfg.nlo, cfg.nypo, cfg.nxpo)
        assert np.isfinite(f.variables["uptpoc"][:]).all()


def test_driver_mesh_run_matches_single_device(tmp_path):
    """The production Driver on a device mesh (a2a spectral solvers,
    sharded chunk carry) writes the same trajectory as the
    single-device run -- multi-chip runs go through the same driver,
    cadences and writers (replacing the reference's single-node-only
    job, src/cntl_q-gcm:8)."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    from qgcm_tpu.config import ModelConfig
    from qgcm_tpu.run import run_case
    from qgcm_tpu.generators import eddy_pressure, zero_forcing
    from qgcm_tpu.model import build_model
    from qgcm_tpu.models.ocean import init_ocean_state
    from qgcm_tpu.io import save_restart
    from qgcm_tpu.models.atmos import init_atmos_state
    from qgcm_tpu.parallel.mesh import make_mesh

    base = ModelConfig(nxta=24, nyta=24, nxaooc=24, nyaooc=12, ndxr=2,
                       fnot=5.92e-5, beta=2.08e-11,
                       ocean_only=True, cyclic_ocean=True)
    p = RunParams(trun=0.5 / 365.0, dta=150.0, nstr=3, dxo=20.0e3,
                  delek=0.0, valday=0.125, odiday=0.0, adiday=0.0,
                  dgnday=0.25, prtday=0.0, resday=0.25, dtavoc=0.25,
                  dtavat=0.0, ah2oc=(0.0, 0.0), ah4oc=(0.0, 0.0),
                  tabsoc=(287.0, 282.0), hoc=(800.0, 3.2e20),
                  gpoc=(0.01,), name="zero")
    cfg = params_to_config(p, base)
    model = build_model(cfg)
    oc = init_ocean_state(model, po=eddy_pressure(cfg))
    at = init_atmos_state(model, init="rbal")
    rst = str(tmp_path / "restart_in.nc")
    save_restart(rst, model, oc, at, 0.0)
    p.name = rst

    ref = run_case(p, base, str(tmp_path / "ref"),
                   mean_forcing=zero_forcing(cfg), verbose=False)
    mesh = make_mesh(jax.devices()[:8], rows_only=True)
    out = run_case(p, base, str(tmp_path / "mesh"),
                   mean_forcing=zero_forcing(cfg), verbose=False,
                   mesh=mesh)
    assert not ref.aborted and not out.aborted
    a, b = np.asarray(ref.ocean.po), np.asarray(out.ocean.po)
    assert np.abs(a - b).max() < 1e-12 * np.abs(a).max()
    a, b = np.asarray(ref.ocean.sst), np.asarray(out.ocean.sst)
    assert np.abs(a - b).max() < 1e-12 * (np.abs(a).max() + 1e-30)
    from scipy.io import netcdf_file
    with netcdf_file(str(tmp_path / "mesh" / "monit.nc"), "r",
                     mmap=False) as f:
        assert np.isfinite(f.variables["kealoc"][:]).all()


def test_driver_full_diagnostics(tmp_path):
    """Coupled driver run with covariance, area boxes, qocdiag and the
    k247 ocean-average stream all enabled."""
    from qgcm_tpu.config import double_gyre_coupled, OceanConfig
    from qgcm_tpu.run import Driver
    from qgcm_tpu.model import build_model
    from qgcm_tpu.models.ocean import init_ocean_state
    from qgcm_tpu.models.atmos import init_atmos_state
    from qgcm_tpu.params import params_to_config
    from scipy.io import netcdf_file

    base = double_gyre_coupled(nxta=24, nyta=12, nxaooc=8, nyaooc=8,
                               ndxr=4, ocean=OceanConfig(dxo=20.0e3))
    p = RunParams(trun=0.5 / 365.0, dta=180.0, nstr=3, dxo=20.0e3,
                  valday=0.125, odiday=0.25, adiday=0.25, dgnday=0.125,
                  prtday=0.0, resday=0.0, dtavoc=0.25, dtavat=0.25,
                  dtcovoc=0.125, dtcovat=0.125, name="rbal")
    cfg = params_to_config(p, base)
    model = build_model(cfg)
    oc = init_ocean_state(model, init="rbal")
    at = init_atmos_state(model, init="rbal")

    limits = tmp_path / "areas.limits"
    limits.write_text(
        "   2                 !!nareoc\n"
        "   0.0d3  100.0d3    !!xlooc\n"
        " 300.0d3  260.0d3    !!xhioc\n"
        "   0.0d3   50.0d3    !!ylooc\n"
        " 300.0d3  250.0d3    !!yhioc\n"
        "   oc1      oc2      !!areaoc\n"
        "   1                 !!nareat\n"
        "   0.0d3             !!xloat\n"
        " 1000.0d3            !!xhiat\n"
        "   0.0d3             !!yloat\n"
        "  900.0d3            !!yhiat\n"
        "   at1               !!areaat\n")

    out = str(tmp_path / "out")
    drv = Driver(model, p, out, areas_limits=str(limits),
                 qoc_diag=True, ocavg_days=0.25, verbose=False)
    res = drv.run()
    assert not res.aborted

    with netcdf_file(out + "/areas.nc", "r", mmap=False) as f:
        assert f.variables["tavoc"].shape[1] == 2
        assert np.isfinite(f.variables["tavoc"][:]).all()
    with netcdf_file(out + "/covar.nc", "r", mmap=False) as f:
        # reference covout schema: packed lower-triangle SSP + mean +
        # weight sum per sampled field (covaria_diag.F:241-357)
        nv = f.dimensions["nvcvoc"]
        assert f.dimensions["nmcvoc"] == nv * (nv + 1) // 2
        ssp = f.variables["covto"][:]
        assert ssp.shape == (nv * (nv + 1) // 2,)
        # diagonal entries of an SSP are non-negative
        diag_idx = np.arange(nv) * (np.arange(nv) + 3) // 2
        assert (ssp[diag_idx] >= -1e-6).all()
        assert float(f.variables["swtto"][0]) >= 2.0
        for nm in ("covpa", "avgpa", "swtpa", "avgpo", "covpo"):
            assert nm in f.variables
    with netcdf_file(out + "/qocdiag.nc", "r", mmap=False) as f:
        dq = f.variables["dqdt"][:]
        pieces = sum(f.variables[n][:] for n in
                     ("qotjac", "qt2dif", "qt4dif", "qotent"))
        assert np.allclose(dq, pieces, atol=1e-6 * np.abs(dq).max())
    import os as _os
    avg = sorted(_os.listdir(out + "/avg"))
    assert len(avg) >= 2


def test_reports():
    from qgcm_tpu.config import double_gyre_coupled, OceanConfig
    from qgcm_tpu.model import build_model
    from qgcm_tpu.report import (startup_report, memory_report,
                                 sample_report, derived_parameters)
    from qgcm_tpu.models.ocean import init_ocean_state
    from qgcm_tpu.models.atmos import init_atmos_state

    cfg = double_gyre_coupled(nxta=24, nyta=12, nxaooc=8, nyaooc=8,
                              ndxr=4, ocean=OceanConfig(dxo=20.0e3))
    model = build_model(cfg)
    d = derived_parameters(model)
    assert d["cfl_gw_oc"] < 1.0 and d["cfl_gw_at"] < 1.0
    assert len(d["rdefoc_km"]) == cfg.nlo - 1
    text = startup_report(model)
    assert "deformation radii" in text and "Munk width" in text
    mem = memory_report(model)
    assert "total" in mem
    oc = init_ocean_state(model, init="rbal")
    at = init_atmos_state(model, init="rbal")
    samp = sample_report(model, oc, at)
    assert "po[0]" in samp and "hmixa" in samp


def test_driver_abort_on_blowup(tmp_path):
    """Fail-fast path: an unstable configuration (del4 coefficient far
    above the stability limit) must abort on the validity scan and
    still leave post-mortem artifacts (q-gcm.F:1278-1322 semantics)."""
    from qgcm_tpu.config import ModelConfig, OceanConfig
    from qgcm_tpu.run import run_case
    from qgcm_tpu.generators import eddy_pressure, zero_forcing
    from qgcm_tpu.model import build_model
    from qgcm_tpu.models.ocean import init_ocean_state
    from qgcm_tpu.models.atmos import init_atmos_state
    from qgcm_tpu.io import save_restart

    base = ModelConfig(nxta=24, nyta=24, nxaooc=24, nyaooc=12, ndxr=2,
                       fnot=5.92e-5, beta=2.08e-11,
                       ocean_only=True, cyclic_ocean=True)
    p = RunParams(trun=2.0 / 365.0, dta=150.0, nstr=3, dxo=20.0e3,
                  delek=0.0, valday=0.125, odiday=0.5, adiday=0.0,
                  dgnday=0.0, prtday=0.0, resday=0.0, dtavoc=0.0,
                  dtavat=0.0,
                  ah2oc=(0.0, 0.0), ah4oc=(1e17, 1e17),   # unstable
                  tabsoc=(287.0, 282.0), hoc=(800.0, 3.2e20),
                  gpoc=(0.01,), name="zero")
    cfg = params_to_config(p, base)
    model = build_model(cfg)
    oc = init_ocean_state(model, po=eddy_pressure(cfg))
    at = init_atmos_state(model, init="rbal")
    rst = str(tmp_path / "r0.nc")
    save_restart(rst, model, oc, at, 0.0)
    p.name = rst
    import io
    from contextlib import redirect_stdout
    buf = io.StringIO()
    with redirect_stdout(buf):
        res = run_case(p, base, str(tmp_path / "out"),
                       mean_forcing=zero_forcing(cfg), verbose=True)
    assert res.aborted
    assert res.steps_done < round(p.trun * 365 * 86400 / p.dta)
    # post-mortem snapshot written on abort
    assert (tmp_path / "out" / "ocpo.nc").exists()
    # scan2D/3D-style neighbourhood dump (valsubs.F:631-744): the log
    # names the offending (k, j, i) and prints a patch of values
    log = buf.getvalue()
    assert "VALIDITY FAILURE" in log
    assert "post-mortem" in log
    import re
    m = re.search(r"qo = (\S+) located at k, j, i = "
                  r"(\d+) (\d+) (\d+)", log)
    assert m, log[-2000:]
    k, j, i = int(m.group(2)), int(m.group(3)), int(m.group(4))
    # the dumped extremum really is the field maximum at that point
    # (or a NaN, which argmax surfaces first on a blown-up field)
    qo = np.abs(np.asarray(res.ocean.qo))
    assert np.isnan(qo[k, j, i]) or qo[k, j, i] == np.nanmax(qo)
    # and the patch rows carry the column-index header
    assert re.search(rf"\b{max(0, i - 3)}\b.*\b{i}\b", log)


def test_driver_atmos_only(tmp_path):
    """Atmos-only driver over prescribed mean SST."""
    from qgcm_tpu.config import double_gyre_coupled, OceanConfig
    from qgcm_tpu.run import run_case
    import numpy as np

    base = double_gyre_coupled(nxta=24, nyta=12, nxaooc=8, nyaooc=8,
                               ndxr=4, atmos_only=True,
                               ocean=OceanConfig(dxo=20.0e3))
    p = RunParams(trun=0.25 / 365.0, dta=180.0, nstr=3, dxo=20.0e3,
                  valday=0.125, odiday=0.0, adiday=0.25, dgnday=0.125,
                  prtday=0.0, resday=0.0, dtavoc=0.0, dtavat=0.25,
                  name="rbal")
    cfg = params_to_config(p, base)
    sst = np.zeros((cfg.nyto, cfg.nxto))
    res = run_case(p, base, str(tmp_path / "out"), sst_mean=sst,
                   verbose=False)
    assert not res.aborted
    for f in ("monit.nc", "atpa.nc", "atast.nc", "avges.nc"):
        assert (tmp_path / "out" / f).exists(), f


def test_driver_exact_misaligned_cadence(tmp_path):
    """cadence_rounding="exact" (this framework's extension) honours
    cadences at ANY whole atmospheric step: a valday of 4 steps with
    nstr=3 keeps chunk=4 -- chunk boundaries fall MID coupling cycle --
    and the trajectory equals the aligned single-chunk run (the chunk
    program's partial-cycle lead/tail segments are exercised at every
    phase 1, 2, 0).  The default rounds the same cadence to a whole
    number of coupling cycles, exactly like the reference
    (nint(days*secday/dto)*nstr, q-gcm.F:656-698)."""
    from qgcm_tpu.config import double_gyre_coupled, OceanConfig
    from qgcm_tpu.run import Driver
    from qgcm_tpu.model import build_model

    base = double_gyre_coupled(nxta=24, nyta=12, nxaooc=8, nyaooc=8,
                               ndxr=4, ocean=OceanConfig(dxo=20.0e3))
    model = build_model(base)
    # dta=180 s, nstr=3; trun = 36 atmos steps; valday = 720 s = 4
    # steps (not a multiple of nstr)
    trun = 36 * 180.0 / 86400.0 / 365.0
    p = RunParams(trun=trun, dta=180.0, nstr=3, dxo=20.0e3,
                  valday=720.0 / 86400.0, odiday=0.0, adiday=0.0,
                  dgnday=0.0, prtday=0.0, resday=0.0, dtavoc=0.0,
                  dtavat=0.0, name="rbal")
    # reference parity (default): nint(720/540)*3 = 3 steps
    with pytest.warns(UserWarning, match="coupling cycles"):
        drv_ref = Driver(model, p, str(tmp_path / "ref"),
                         verbose=False)
    assert drv_ref.nvalid == 3
    with pytest.warns(UserWarning, match="chunk program"):
        drv = Driver(model, p, str(tmp_path / "a"), verbose=False,
                     cadence_rounding="exact")
    assert drv.nvalid == 4 and drv.chunk == 4 and drv.nsteps == 36
    res = drv.run()
    assert not res.aborted and res.steps_done == 36

    # aligned control: same run in whole-cycle chunks
    p2 = RunParams(trun=trun, dta=180.0, nstr=3, dxo=20.0e3,
                   valday=1080.0 / 86400.0, odiday=0.0, adiday=0.0,
                   dgnday=0.0, prtday=0.0, resday=0.0, dtavoc=0.0,
                   dtavat=0.0, name="rbal")
    drv2 = Driver(model, p2, str(tmp_path / "b"), verbose=False)
    assert drv2.chunk == 6
    res2 = drv2.run()
    for a, b in ((res.ocean.po, res2.ocean.po),
                 (res.ocean.sst, res2.ocean.sst),
                 (res.atmos.pa, res2.atmos.pa),
                 (res.atmos.ast, res2.atmos.ast)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-12, atol=1e-14)


def test_cadence_rounding_warns(tmp_path):
    """A cadence the reference would honour exactly but that is not a
    whole number of coupling cycles must warn (with the rounded value),
    and exactly-representable cadences must stay silent."""
    import warnings
    from qgcm_tpu.config import double_gyre_coupled, OceanConfig
    from qgcm_tpu.run import Driver
    from qgcm_tpu.model import build_model

    base = double_gyre_coupled(nxta=24, nyta=12, nxaooc=8, nyaooc=8,
                               ndxr=4, ocean=OceanConfig(dxo=20.0e3))
    model = build_model(base)
    # dta=180 s, nstr=3 -> cycle = 540 s.  valday=0.0125 d = 1080 s =
    # exactly 2 cycles (silent); 0.01 d = 864 s = 4.8 steps (warns).
    p = RunParams(trun=0.01 / 365.0, dta=180.0, nstr=3, dxo=20.0e3,
                  valday=0.0125, odiday=0.0, adiday=0.0, dgnday=0.0,
                  prtday=0.0, resday=0.0, dtavoc=0.0, dtavat=0.0,
                  name="rbal")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        Driver(model, p, str(tmp_path / "a"), verbose=False)

    p2 = RunParams(trun=0.01 / 365.0, dta=180.0, nstr=3, dxo=20.0e3,
                   valday=0.01, odiday=0.0, adiday=0.0, dgnday=0.0,
                   prtday=0.0, resday=0.0, dtavoc=0.0, dtavat=0.0,
                   name="rbal")
    with pytest.warns(UserWarning, match="valday"):
        Driver(model, p2, str(tmp_path / "b"), verbose=False)


def test_driver_profile(tmp_path, capsys):
    """--profile: the driver traces a steady-state chunk and prints a
    per-kernel device-time report (profiling.summarize)."""
    from qgcm_tpu.config import ModelConfig, OceanConfig
    from qgcm_tpu.run import run_case
    from qgcm_tpu.generators import eddy_pressure, zero_forcing
    from qgcm_tpu.model import build_model
    from qgcm_tpu.models.ocean import init_ocean_state
    from qgcm_tpu.models.atmos import init_atmos_state
    from qgcm_tpu.io import save_restart
    from qgcm_tpu.profiling import summarize

    base = ModelConfig(nxta=24, nyta=24, nxaooc=24, nyaooc=12, ndxr=2,
                       fnot=5.92e-5, beta=2.08e-11,
                       ocean_only=True, cyclic_ocean=False)
    p = RunParams(trun=0.75 / 365.0, dta=150.0, nstr=3, dxo=20.0e3,
                  delek=0.0, valday=0.25, odiday=0.0, adiday=0.0,
                  dgnday=0.0, prtday=0.0, resday=0.0, dtavoc=0.0,
                  dtavat=0.0, ah2oc=(0.0, 0.0), ah4oc=(0.0, 0.0),
                  tabsoc=(287.0, 282.0), hoc=(800.0, 3.2e20),
                  gpoc=(0.01,), name="zero")
    cfg = params_to_config(p, base)
    model = build_model(cfg)
    oc = init_ocean_state(model, po=eddy_pressure(cfg))
    at = init_atmos_state(model, init="rbal")
    rst = str(tmp_path / "restart_in.nc")
    save_restart(rst, model, oc, at, 0.0)
    p.name = rst

    prof = str(tmp_path / "prof")
    res = run_case(p, base, str(tmp_path / "out"),
                   mean_forcing=zero_forcing(cfg), verbose=True,
                   profile_dir=prof)
    assert not res.aborted
    out = capsys.readouterr().out
    assert "device op time" in out and "top ops" in out

    # the trace parses standalone and attributes real device time
    s = summarize(prof)
    assert s.total_us > 0
    assert s.top(3)


def test_no_cadence_runs_one_big_chunk(tmp_path):
    """With every diagnostic/I-O cadence disabled, nothing forces a
    host wake-up, so the chunk must be the whole run (capped) -- the
    old gcd fallback of chunk=nstr dispatched ONE coupling cycle per
    host round-trip."""
    from qgcm_tpu.config import ModelConfig, OceanConfig
    from qgcm_tpu.run import Driver
    from qgcm_tpu.model import build_model
    from qgcm_tpu.generators import zero_forcing

    base = ModelConfig(nxta=24, nyta=24, nxaooc=24, nyaooc=12, ndxr=2,
                       fnot=5.92e-5, beta=2.08e-11,
                       ocean_only=True, cyclic_ocean=True)
    p = RunParams(trun=60.0 * 300.0 / 86400.0 / 365.0, dta=300.0,
                  nstr=3, dxo=20.0e3, delek=0.0,
                  valday=0.0, odiday=0.0, adiday=0.0,
                  dgnday=0.0, prtday=0.0, resday=0.0, dtavoc=0.0,
                  dtavat=0.0, ah2oc=(0.0, 0.0), ah4oc=(0.0, 0.0),
                  tabsoc=(287.0, 282.0), hoc=(800.0, 3.2e20),
                  gpoc=(0.01,), name="zero")
    cfg = params_to_config(p, base)
    model = build_model(cfg)
    drv = Driver(model, p, str(tmp_path / "out"),
                 mean_forcing=zero_forcing(cfg), verbose=False)
    assert drv.chunk == drv.nsteps == 60
    res = drv.run()
    assert res.steps_done == 60 and not res.aborted


def test_driver_midcycle_restart_resume(tmp_path):
    """A restart cadence that is not a multiple of nstr (exact-cadence
    extension) writes restart.nc MID coupling cycle; resuming from it
    must (a) derive the absolute step index from the stored time,
    (b) re-enter the open cycle at the right phase (the first chunk's
    lead segment) UNDER THE SAME FORCING the uninterrupted run used
    (the dump embeds the open cycle's ofor/afor -- recomputing from
    the advanced m-slots would silently diverge), so the resumed
    trajectory matches a straight-through control, and (c) fire events
    on the RELATIVE cadence grid, like the reference's
    mod(ntdone, nout*) tests with ntdone = nt - nsteps0
    (q-gcm.F:1271-1272,1277)."""
    from qgcm_tpu.config import double_gyre_coupled, OceanConfig
    from qgcm_tpu.run import Driver
    from qgcm_tpu.model import build_model

    base = double_gyre_coupled(nxta=24, nyta=12, nxaooc=8, nyaooc=8,
                               ndxr=4, ocean=OceanConfig(dxo=20.0e3))
    model = build_model(base)
    day = 86400.0
    # straight-through control: 18 steps, no events
    pc = RunParams(trun=18 * 180.0 / day / 365.0, dta=180.0, nstr=3,
                   dxo=20.0e3, valday=0.0, odiday=0.0, adiday=0.0,
                   dgnday=0.0, prtday=0.0, resday=0.0,
                   dtavoc=0.0, dtavat=0.0, name="rbal")
    ctl = Driver(model, pc, str(tmp_path / "ctl"), verbose=False).run()
    assert ctl.steps_done == 18

    # dta=180, nstr=3: run 10 steps, restart cadence every 10 steps
    # (10 % 3 != 0 -> the dump lands mid-cycle at phase 1)
    p = RunParams(trun=10 * 180.0 / day / 365.0, dta=180.0, nstr=3,
                  dxo=20.0e3, valday=0.0, odiday=0.0, adiday=0.0,
                  dgnday=0.0, prtday=0.0, resday=10 * 180.0 / day,
                  dtavoc=0.0, dtavat=0.0, name="rbal")
    drv = Driver(model, p, str(tmp_path / "a"), verbose=False,
                 cadence_rounding="exact")
    assert drv.nrestart == 10
    res = drv.run()
    assert res.steps_done == 10
    rst = tmp_path / "a" / "restart.nc"
    assert rst.exists()
    # the mid-cycle dump embeds the open cycle's forcing
    from scipy.io import netcdf_file
    with netcdf_file(str(rst), "r", mmap=False) as f:
        assert "tauxa" in f.variables and "tauxo" in f.variables

    # resume for 8 more steps: step0=10 -> phase 1 (2 lead atmos
    # steps complete the open cycle); the monitor cadence of 6 steps
    # fires ONCE on the relative grid, at ntdone=6 = absolute step 16
    # (ntdone semantics -- an absolute grid would give 12 and 18)
    p2 = RunParams(trun=8 * 180.0 / day / 365.0, dta=180.0, nstr=3,
                   dxo=20.0e3, valday=0.0, odiday=0.0, adiday=0.0,
                   dgnday=6 * 180.0 / day, prtday=0.0, resday=0.0,
                   dtavoc=0.0, dtavat=0.0, name=str(rst))
    drv2 = Driver(model, p2, str(tmp_path / "b"), verbose=False,
                  cadence_rounding="exact")
    res2 = drv2.run()
    assert res2.steps_done == 8
    assert abs(res2.tyrs - 18 * 180.0 / (86400.0 * 365.0)) < 1e-12
    with netcdf_file(str(tmp_path / "b" / "monit.nc"), "r",
                     mmap=False) as f:
        t = f.variables["time"][:].copy()
    assert len(t) == 1
    np.testing.assert_allclose(
        t * 365.0 * 86400.0 / 180.0, [16.0], atol=1e-6)

    # trajectory faithfulness: the resumed run ends where the
    # straight-through control does (restart rederives q from p, so
    # agreement is at inversion exactness, not bit level -- the
    # reference's own resume has the same property, q-gcm.F:715-750)
    for a, b in ((res2.ocean.po, ctl.ocean.po),
                 (res2.ocean.sst, ctl.ocean.sst),
                 (res2.atmos.pa, ctl.atmos.pa),
                 (res2.atmos.ast, ctl.atmos.ast)):
        a, b = np.asarray(a), np.asarray(b)
        assert np.abs(a - b).max() <= 1e-9 * (np.abs(b).max() + 1e-30)


def test_cli_run_resume_chains_segments(tmp_path):
    """`qgcm run --resume`: continues from the newest checkpoint of
    the newest segment into a FRESH outdata_rK dir (the reference's
    restart-chaining workflow, exec_qgcm.rb:82-87: one outdata dir per
    segment, unified afterwards), with time carrying on from tini and
    the unified monit series gapless."""
    from qgcm_tpu.cli import main
    from qgcm_tpu.analysis import unify_monit
    from scipy.io import netcdf_file

    case = tmp_path / "case"
    case.mkdir()
    day = 86400.0
    # 12 steps, monit every cycle, restart dump at the end
    (case / "input.params").write_text(
        f" {12 * 150.0 / day / 365.0:.12e}  !! trun\n"
        " 150.0d0   !! dta\n 3   !! nstr\n 20.0d3  !! dxo\n"
        " 0.0d0  !! delek\n 1.3d-3 !! cdat\n 1.0d0 !! rhoat\n"
        " 1.0d3 !! rhooc\n 1.0d3 !! cpat\n 4.0d3 !! cpoc\n"
        " 1.0d0 !! bccoat\n 0.2d0 !! bccooc\n 1.0d0 !! xcexp\n"
        " 1.0d0 !! ycexp\n 0.0d0 !! valday\n 0.0d0 !! odiday\n"
        " 0.0d0 !! adiday\n"
        f" {3 * 150.0 / day:.12e} !! dgnday\n"
        " 0.0d0 !! prtday\n"
        f" {12 * 150.0 / day:.12e} !! resday\n"
        " 1 !! nsko\n 1 !! nska\n 0.0d0 !! dtavat\n 0.0d0 !! dtavoc\n"
        " 0.0d0 !! dtcovat\n 0.0d0 !! dtcovoc\n 35.0d0 !! xlamda\n"
        " 100.0d0 !! hmoc\n 100.0d0 !! st2d\n 2.0d9 !! st4d\n"
        " 1000.0d0 !! hmat\n 100.0d0 !! hmamin\n 2.0d5 !! ahmd\n"
        " 2.5d4 !! at2d\n 2.0d14 !! at4d\n 0.15d0 !! hmadmp\n"
        " -210.0d0 !! fsbar\n 80.0d0 !! fspamp\n 2.0d2 !! zm\n"
        " 2.0d4 2.0d4 3.0d4 !! zopt\n 1.0d-2 !! gamma\n"
        " 0.0d0 0.0d0 !! ah2oc\n 0.0d0 0.0d0 !! ah4oc\n"
        " 287.0d0 282.0d0 !! tabsoc\n 800.0d0 3.2d20 !! hoc\n"
        " 0.01d0 !! gpoc\n 1.5d14 1.5d14 1.5d14 !! ah4at\n"
        " 330.0d0 340.0d0 350.0d0 !! tabsat\n"
        " 2000.0d0 3000.0d0 4000.0d0 !! hat\n 1.2d0 0.4d0 !! gpat\n"
        " zero !! name\n flat !! topocname\n flat !! topatname\n"
        " 1 1 1 1 1 1 1 !! outfloc\n 1 1 1 1 1 1 1 !! outflat\n")
    flags = ["--nxta", "24", "--nyta", "24", "--nxaooc", "24",
             "--nyaooc", "12", "--ndxr", "2", "--fnot", "5.92e-5",
             "--beta", "2.08e-11", "--ocean-only", "--cyclic-ocean"]
    assert main(["prepare", str(case), "--eddy-amp", "0.15",
                 "--forcing", "zero"] + flags) in (0, None)
    assert main(["run", str(case), "--quiet"] + flags) in (0, None)
    assert (case / "outdata" / "restart.nc").exists()
    # resume for 12 more steps into a fresh segment dir
    assert main(["run", str(case), "--quiet", "--resume"]
                + flags) in (0, None)
    seg2 = case / "outdata_r2"
    assert (seg2 / "monit.nc").exists()
    with netcdf_file(str(seg2 / "monit.nc"), "r", mmap=False) as f:
        t2 = f.variables["time"][:].copy()
    # continued the clock: first segment ended at step 12
    step = 150.0 / day / 365.0
    np.testing.assert_allclose(
        t2 / step, [15.0, 18.0, 21.0, 24.0], rtol=1e-5)
    uni = tmp_path / "monit_unified.nc"
    unify_monit([str(case / "outdata"), str(seg2)], str(uni))
    with netcdf_file(str(uni), "r", mmap=False) as f:
        t = f.variables["time"][:].copy()
        assert np.isfinite(f.variables["kealoc"][:]).all()
    np.testing.assert_allclose(
        t / step, [3, 6, 9, 12, 15, 18, 21, 24], rtol=1e-5)

    # the same unification through the CLI (qgcm analyze --chain,
    # the Ruby prep workflow)
    assert main(["analyze", str(case / "outdata"),
                 "--chain"]) in (0, None)
    with netcdf_file(str(case / "outdata_unified" / "monit.nc"), "r",
                     mmap=False) as f:
        t = f.variables["time"][:].copy()
    np.testing.assert_allclose(
        t / step, [3, 6, 9, 12, 15, 18, 21, 24], rtol=1e-5)


def test_cadence_nint_rounds_half_away_from_zero(tmp_path):
    """Fortran NINT parity: a cadence landing exactly on a half cycle
    rounds AWAY from zero (nint(2.5)=3), where Python's banker's
    round() would give 2 -- silently shifting event schedules."""
    import warnings
    from qgcm_tpu.config import double_gyre_coupled, OceanConfig
    from qgcm_tpu.run import Driver
    from qgcm_tpu.model import build_model

    base = double_gyre_coupled(nxta=24, nyta=12, nxaooc=8, nyaooc=8,
                               ndxr=4, ocean=OceanConfig(dxo=20.0e3))
    model = build_model(base)
    # dta=180, nstr=3 -> dto=540; valday = 1350 s = 2.5 cycles
    p = RunParams(trun=0.01 / 365.0, dta=180.0, nstr=3, dxo=20.0e3,
                  valday=1350.0 / 86400.0, odiday=0.0, adiday=0.0,
                  dgnday=0.0, prtday=0.0, resday=0.0, dtavoc=0.0,
                  dtavat=0.0, name="rbal")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        drv = Driver(model, p, str(tmp_path / "a"), verbose=False)
    assert drv.nvalid == 9        # nint(2.5)*3, NOT round(2.5)*3 == 6


def test_no_cadence_odd_length_does_not_warn(tmp_path):
    """A no-cadence run whose length is not a multiple of nstr is ONE
    chunk with one phase -- the multi-phase compile warning must not
    fire (it is about exact-mode cadence chunks only)."""
    import warnings
    from qgcm_tpu.config import double_gyre_coupled, OceanConfig
    from qgcm_tpu.run import Driver
    from qgcm_tpu.model import build_model

    base = double_gyre_coupled(nxta=24, nyta=12, nxaooc=8, nyaooc=8,
                               ndxr=4, ocean=OceanConfig(dxo=20.0e3))
    model = build_model(base)
    p = RunParams(trun=10 * 180.0 / 86400.0 / 365.0, dta=180.0,
                  nstr=3, dxo=20.0e3, valday=0.0, odiday=0.0,
                  adiday=0.0, dgnday=0.0, prtday=0.0, resday=0.0,
                  dtavoc=0.0, dtavat=0.0, name="rbal")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        drv = Driver(model, p, str(tmp_path / "a"), verbose=False)
    assert drv.nsteps == 10 and drv.chunk == 10


def test_abort_leaves_no_lastday_checkpoint(tmp_path):
    """An aborted run must NOT leave the invalid state as the newest
    checkpoint: the reference writes its final resave only at normal
    termination (q-gcm.F:1528-1539), and --resume picks checkpoints by
    recency."""
    from qgcm_tpu.config import ModelConfig, OceanConfig
    from qgcm_tpu.run import run_case
    from qgcm_tpu.generators import eddy_pressure, zero_forcing
    from qgcm_tpu.model import build_model
    from qgcm_tpu.models.ocean import init_ocean_state
    from qgcm_tpu.models.atmos import init_atmos_state
    from qgcm_tpu.io import save_restart

    base = ModelConfig(nxta=24, nyta=24, nxaooc=24, nyaooc=12, ndxr=2,
                       fnot=5.92e-5, beta=2.08e-11,
                       ocean_only=True, cyclic_ocean=True)
    p = RunParams(trun=2.0 / 365.0, dta=150.0, nstr=3, dxo=20.0e3,
                  delek=0.0, valday=0.125, odiday=0.5, adiday=0.0,
                  dgnday=0.0, prtday=0.0, resday=0.0, dtavoc=0.0,
                  dtavat=0.0, ah2oc=(0.0, 0.0), ah4oc=(1e17, 1e17),
                  tabsoc=(287.0, 282.0), hoc=(800.0, 3.2e20),
                  gpoc=(0.01,), name="zero")
    cfg = params_to_config(p, base)
    model = build_model(cfg)
    oc = init_ocean_state(model, po=eddy_pressure(cfg))
    at = init_atmos_state(model, init="rbal")
    rst = str(tmp_path / "r0.nc")
    save_restart(rst, model, oc, at, 0.0)
    p.name = rst
    res = run_case(p, base, str(tmp_path / "out"),
                   mean_forcing=zero_forcing(cfg), verbose=False)
    assert res.aborted
    assert not (tmp_path / "out" / "lastday.nc").exists()


def test_cli_resume_refuses_overwriting_source_segment(tmp_path):
    """--resume with --outdir pointing at the segment being resumed
    from would truncate that segment's outputs; it must be refused."""
    from qgcm_tpu.cli import main

    case = tmp_path / "case"
    case.mkdir()
    flags = ["--nxta", "24", "--nyta", "24", "--nxaooc", "24",
             "--nyaooc", "12", "--ndxr", "2", "--fnot", "5.92e-5",
             "--beta", "2.08e-11", "--ocean-only", "--cyclic-ocean"]
    assert main(["prepare", str(case), "--eddy-amp", "0.15",
                 "--forcing", "zero"] + flags) in (0, None)
    assert main(["run", str(case), "--quiet", "--trun", "2e-5"]
                + flags) in (0, None)
    with pytest.raises(SystemExit, match="segment being"):
        main(["run", str(case), "--quiet", "--resume", "--trun",
              "2e-5", "--outdir", str(case / "outdata")] + flags)


def test_driver_orbax_checkpoint_roundtrip(tmp_path):
    """ckpt_format="orbax": the Driver writes sharded checkpoint
    directories (restart_orbax/, lastday_orbax/) instead of the
    gathered restart.nc, and a resume from the directory -- restored
    straight into the run's mesh sharding -- continues the trajectory
    (same inversion-exactness agreement as the netCDF path)."""
    import jax
    from qgcm_tpu.config import double_gyre_coupled, OceanConfig
    from qgcm_tpu.run import Driver
    from qgcm_tpu.model import build_model
    day = 86400.0

    base = double_gyre_coupled(nxta=24, nyta=12, nxaooc=8, nyaooc=8,
                               ndxr=4, ocean=OceanConfig(dxo=20.0e3))
    model = build_model(base)
    mesh = None
    if len(jax.devices()) >= 4:
        from qgcm_tpu.parallel.mesh import make_mesh
        mesh = make_mesh(jax.devices()[:4], rows_only=True)

    pc = RunParams(trun=18 * 180.0 / day / 365.0, dta=180.0, nstr=3,
                   dxo=20.0e3, valday=0.0, odiday=0.0, adiday=0.0,
                   dgnday=0.0, prtday=0.0, resday=0.0,
                   dtavoc=0.0, dtavat=0.0, name="rbal")
    ctl = Driver(model, pc, str(tmp_path / "ctl"), verbose=False).run()

    p1 = RunParams(trun=12 * 180.0 / day / 365.0, dta=180.0, nstr=3,
                   dxo=20.0e3, valday=0.0, odiday=0.0, adiday=0.0,
                   dgnday=0.0, prtday=0.0,
                   resday=6 * 180.0 / day,       # 2 cycles
                   dtavoc=0.0, dtavat=0.0, name="rbal")
    r1 = Driver(model, p1, str(tmp_path / "a"), verbose=False,
                mesh=mesh, ckpt_format="orbax").run()
    assert not r1.aborted
    assert (tmp_path / "a" / "restart_orbax").is_dir()
    assert (tmp_path / "a" / "lastday_orbax").is_dir()
    assert not (tmp_path / "a" / "restart.nc").exists()

    p2 = RunParams(trun=6 * 180.0 / day / 365.0, dta=180.0, nstr=3,
                   dxo=20.0e3, valday=0.0, odiday=0.0, adiday=0.0,
                   dgnday=0.0, prtday=0.0, resday=0.0, dtavoc=0.0,
                   dtavat=0.0,
                   name=str(tmp_path / "a" / "lastday_orbax"))
    r2 = Driver(model, p2, str(tmp_path / "b"), verbose=False,
                mesh=mesh, ckpt_format="orbax").run()
    assert r2.steps_done == 6
    assert abs(r2.tyrs - 18 * 180.0 / (day * 365.0)) < 1e-12
    for name, a, b in (("po", r2.ocean.po, ctl.ocean.po),
                       ("sst", r2.ocean.sst, ctl.ocean.sst),
                       ("pa", r2.atmos.pa, ctl.atmos.pa)):
        a, b = np.asarray(a), np.asarray(b)
        scale = np.abs(b).max() + 1e-30
        assert np.abs(a - b).max() <= 1e-9 * scale, name


def test_driver_orbax_elastic_resume(tmp_path):
    """Elastic recovery: an Orbax checkpoint written by a 4-device mesh
    run restores into a DIFFERENT device layout -- a 2-device mesh and
    a single device -- and both continuations reproduce the
    uninterrupted control trajectory. (The reference's recovery story
    is restart.nc into the same single process; resharding on resume
    is new capability, SURVEY 5.3/5.4.)"""
    import jax
    from qgcm_tpu.config import double_gyre_coupled, OceanConfig
    from qgcm_tpu.run import Driver
    from qgcm_tpu.model import build_model
    from qgcm_tpu.parallel.mesh import make_mesh
    if len(jax.devices()) < 4:
        pytest.skip("needs >=4 devices")
    day = 86400.0

    base = double_gyre_coupled(nxta=24, nyta=12, nxaooc=8, nyaooc=8,
                               ndxr=4, ocean=OceanConfig(dxo=20.0e3))
    model = build_model(base)
    mesh4 = make_mesh(jax.devices()[:4], rows_only=True)
    mesh2 = make_mesh(jax.devices()[:2], rows_only=True)

    pc = RunParams(trun=18 * 180.0 / day / 365.0, dta=180.0, nstr=3,
                   dxo=20.0e3, valday=0.0, odiday=0.0, adiday=0.0,
                   dgnday=0.0, prtday=0.0, resday=0.0,
                   dtavoc=0.0, dtavat=0.0, name="rbal")
    ctl = Driver(model, pc, str(tmp_path / "ctl"), verbose=False).run()

    p1 = RunParams(trun=12 * 180.0 / day / 365.0, dta=180.0, nstr=3,
                   dxo=20.0e3, valday=0.0, odiday=0.0, adiday=0.0,
                   dgnday=0.0, prtday=0.0, resday=0.0,
                   dtavoc=0.0, dtavat=0.0, name="rbal")
    r1 = Driver(model, p1, str(tmp_path / "a"), verbose=False,
                mesh=mesh4, ckpt_format="orbax").run()
    assert (tmp_path / "a" / "lastday_orbax").is_dir()

    p2 = RunParams(trun=6 * 180.0 / day / 365.0, dta=180.0, nstr=3,
                   dxo=20.0e3, valday=0.0, odiday=0.0, adiday=0.0,
                   dgnday=0.0, prtday=0.0, resday=0.0, dtavoc=0.0,
                   dtavat=0.0,
                   name=str(tmp_path / "a" / "lastday_orbax"))
    for tag, mesh in (("b2", mesh2), ("b1", None)):
        r2 = Driver(model, p2, str(tmp_path / tag), verbose=False,
                    mesh=mesh, ckpt_format="orbax").run()
        assert r2.steps_done == 6
        for name, a, b in (("po", r2.ocean.po, ctl.ocean.po),
                           ("sst", r2.ocean.sst, ctl.ocean.sst),
                           ("pa", r2.atmos.pa, ctl.atmos.pa)):
            a, b = np.asarray(a), np.asarray(b)
            scale = np.abs(b).max() + 1e-30
            assert np.abs(a - b).max() <= 1e-9 * scale, (tag, name)


def test_driver_avges_midpoint_sampling(tmp_path):
    """avges_sampling="midpoint" reproduces the reference's
    one-sample-per-interval subsampling (q-gcm.F:1477-1482: accumulate
    at mod(ntdone,ntav)==nmid with nmid=ntav/2; intervals set up at
    :674-694). Pinned against DIRECT STATE SAMPLES: three extra runs
    of the identical trajectory truncated at the midpoint steps
    provide the exact states tavocn/tavatm would have sampled, and
    avges.nc must equal their mean. The ocean sample keys on the
    coupling cycle CONTAINING the midpoint step (the ocean substep
    runs only at cycle heads, q-gcm.F:1222)."""
    from qgcm_tpu.config import double_gyre_coupled, OceanConfig
    from qgcm_tpu.run import run_case
    from qgcm_tpu.model import build_model
    from qgcm_tpu.models.ocean import init_ocean_state
    from qgcm_tpu.models.atmos import init_atmos_state
    from qgcm_tpu.generators import eddy_pressure
    from qgcm_tpu.io import save_restart
    from scipy.io import netcdf_file

    base = double_gyre_coupled(nxta=24, nyta=12, nxaooc=8, nyaooc=8,
                               ndxr=4, ocean=OceanConfig(dxo=20.0e3))
    # dta=180 s, nstr=3; averaging interval = 12 atmos steps (even,
    # whole cycles), nmid = 6; run = 36 steps = 3 intervals, so the
    # midpoint samples land at ntdone = 6, 18, 30
    dtav = 12 * 180.0 / 86400.0

    def mkparams(nsteps, dtav_=0.0):
        return RunParams(trun=nsteps * 180.0 / 86400.0 / 365.0,
                         dta=180.0, nstr=3, dxo=20.0e3,
                         valday=0.0, odiday=0.0, adiday=0.0,
                         dgnday=0.0, prtday=0.0, resday=0.0,
                         dtavoc=dtav_, dtavat=dtav_, name="zero")

    # shared non-trivial IC (eddy ocean + rbal atmos)
    p0 = mkparams(36, dtav)
    cfg = params_to_config(p0, base)
    model = build_model(cfg)
    oc = init_ocean_state(model, po=eddy_pressure(cfg))
    at = init_atmos_state(model, init="rbal")
    rst = str(tmp_path / "restart_in.nc")
    save_restart(rst, model, oc, at, 0.0)

    p0.name = rst
    res = run_case(p0, base, str(tmp_path / "mid"), verbose=False,
                   avges_sampling="midpoint")
    assert not res.aborted and res.steps_done == 36

    # direct state samples at the midpoint steps
    samples = {}
    for nsteps in (6, 18, 30):
        pk = mkparams(nsteps)
        pk.name = rst
        rk = run_case(pk, base, str(tmp_path / f"s{nsteps}"),
                      verbose=False)
        assert not rk.aborted
        with netcdf_file(str(tmp_path / f"s{nsteps}" / "lastday.nc"),
                         "r", mmap=False) as f:
            samples[nsteps] = {v: f.variables[v][:].copy()
                               for v in ("po", "sst", "pa", "ast",
                                         "hmixa")}

    def expect(v):
        return (samples[6][v] + samples[18][v] + samples[30][v]) / 3.0

    with netcdf_file(str(tmp_path / "mid" / "avges.nc"), "r",
                     mmap=False) as f:
        for v in ("po", "sst", "pa", "ast", "hmixa"):
            got = f.variables[v][:]
            np.testing.assert_allclose(
                got, expect(v), rtol=1e-12, atol=1e-14,
                err_msg=f"{v}: midpoint avges != mean of the "
                        f"sampled states")

    # sanity: the default mean mode gives a DIFFERENT (every-step) mean
    p1 = mkparams(36, dtav)
    p1.name = rst
    run_case(p1, base, str(tmp_path / "mean"), verbose=False)
    with netcdf_file(str(tmp_path / "mean" / "avges.nc"), "r",
                     mmap=False) as f1, \
         netcdf_file(str(tmp_path / "mid" / "avges.nc"), "r",
                     mmap=False) as f2:
        assert np.abs(f1.variables["pa"][:]
                      - f2.variables["pa"][:]).max() > 0

    # odd-interval midpoint is undefined: hard stop like the reference
    from qgcm_tpu.run import Driver
    podd = mkparams(36, 9 * 180.0 / 86400.0)
    podd.name = rst
    with pytest.raises(ValueError, match="even"):
        Driver(model, podd, str(tmp_path / "odd"), verbose=False,
               avges_sampling="midpoint")


def test_sense_cli_end_to_end(tmp_path):
    """qgcm sense: adjoint sensitivity from the experiment workflow --
    prepare a small cyclic case with channel forcing, then write
    sensitivity.nc with the gradient fields (docs/adjoint.md)."""
    from qgcm_tpu.cli import main
    from scipy.io import netcdf_file

    case = tmp_path / "case"
    flags = ["--nxta", "24", "--nyta", "18", "--nxaooc", "24",
             "--nyaooc", "6", "--ndxr", "4", "--fnot=-1.19467e-4",
             "--beta", "1.31301e-11", "--ocean-only", "--cyclic-ocean"]
    assert main(["prepare", str(case), "--forcing", "channel"]
                + flags) in (0, None)
    assert main(["sense", str(case), "--objective", "transport",
                 "--days", "0.5"] + flags) in (0, None)
    with netcdf_file(str(case / "outdata" / "sensitivity.nc"), "r",
                     mmap=False) as f:
        for v in ("dJ_dtauxo", "dJ_dtauyo", "dJ_dfnetoc", "dJ_dpo",
                  "dJ_dsst"):
            arr = f.variables[v][:]
            assert np.isfinite(arr).all(), v
        assert np.abs(f.variables["dJ_dtauxo"][:]).max() > 0
        assert np.isfinite(float(f.variables["objective"].getValue()))
