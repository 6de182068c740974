"""Native (C++) netCDF writer: files must be readable by scipy's
independent netCDF3 implementation, byte-compatible semantics."""

import os

import numpy as np
import pytest
from scipy.io import netcdf_file

from qgcm_tpu.io import native

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native writer not buildable")


def test_roundtrip_mixed_vars(tmp_path):
    rng = np.random.default_rng(0)
    path = str(tmp_path / "nat.nc")
    w = native.NativeNcWriter(path)
    w.dim("time", None)
    w.dim("y", 7)
    w.dim("x", 13)
    w.dim("z", 3)
    ycoord = rng.standard_normal(7)
    w.var("y", "d", ("y",), units="km", data=ycoord)
    w.var("time", "f", ("time",), units="years")
    w.var("p", "f", ("time", "z", "y", "x"), units="m^2/s^2",
          long_name="pressure")
    w.var("sst", "d", ("time", "y", "x"))
    frames_p = [rng.standard_normal((3, 7, 13)).astype(np.float32)
                for _ in range(4)]
    frames_s = [rng.standard_normal((7, 13)) for _ in range(4)]
    for r in range(4):
        w.append("time", r, 0.25 * r)
        w.append("p", r, frames_p[r])
        w.append("sst", r, frames_s[r])
    w.flush()
    w.close()

    with netcdf_file(path, "r", mmap=False) as f:
        assert f.variables["p"].shape == (4, 3, 7, 13)
        assert f.variables["p"].units == b"m^2/s^2"
        assert f.variables["p"].long_name == b"pressure"
        np.testing.assert_array_equal(f.variables["y"][:], ycoord)
        for r in range(4):
            np.testing.assert_array_equal(f.variables["p"][r],
                                          frames_p[r])
            np.testing.assert_array_equal(f.variables["sst"][r],
                                          frames_s[r])
        np.testing.assert_allclose(f.variables["time"][:],
                                   [0.0, 0.25, 0.5, 0.75])


def test_single_record_var_special_case(tmp_path):
    """netCDF classic drops record padding when there is exactly one
    record variable; scipy must still read our file."""
    path = str(tmp_path / "one.nc")
    w = native.NativeNcWriter(path)
    w.dim("time", None)
    w.dim("x", 3)
    w.var("v", "f", ("time", "x"))
    for r in range(5):
        w.append("v", r, np.full(3, r, np.float32))
    w.close()
    with netcdf_file(path, "r", mmap=False) as f:
        v = f.variables["v"][:]
        assert v.shape == (5, 3)
        np.testing.assert_array_equal(v[:, 0], np.arange(5))


def test_non_record_only(tmp_path):
    path = str(tmp_path / "static.nc")
    w = native.NativeNcWriter(path)
    w.dim("y", 4)
    w.dim("x", 5)
    data = np.arange(20, dtype=np.float64).reshape(4, 5)
    w.var("topo", "d", ("y", "x"), units="m", data=data)
    w.close()
    with netcdf_file(path, "r", mmap=False) as f:
        np.testing.assert_array_equal(f.variables["topo"][:], data)


def test_async_matches_sync(tmp_path):
    rng = np.random.default_rng(1)
    frames = [rng.standard_normal((16, 33)).astype(np.float32)
              for _ in range(10)]
    paths = []
    for async_io in (False, True):
        path = str(tmp_path / f"m{int(async_io)}.nc")
        w = native.NativeNcWriter(path, async_io=async_io)
        w.dim("time", None)
        w.dim("y", 16)
        w.dim("x", 33)
        w.var("f", "f", ("time", "y", "x"))
        w.var("g", "f", ("time", "y", "x"))
        for r, fr in enumerate(frames):
            w.append("f", r, fr)
            w.append("g", r, -fr)
        w.close()
        paths.append(path)
    a = open(paths[0], "rb").read()
    b = open(paths[1], "rb").read()
    assert a == b


@pytest.mark.parametrize("lib_exists,src_newer,stale", [
    (False, False, True),
    (True, True, True),
    (True, False, False),
], ids=["missing", "older_than_source", "fresh"])
def test_native_lib_rebuilt_when_stale(tmp_path, lib_exists, src_newer,
                                       stale):
    """The shared library is rebuilt when missing or older than
    ncwriter.cc, so an edited source never runs from an old build."""
    from qgcm_tpu.io.native import _stale
    src, lib = tmp_path / "ncwriter.cc", tmp_path / "lib.so"
    src.write_text("// source")
    if lib_exists:
        lib.write_bytes(b"")
        t = os.path.getmtime(src)
        os.utime(lib, (t + (-10 if src_newer else 10),) * 2)
    assert _stale(str(lib), str(src)) is stale
