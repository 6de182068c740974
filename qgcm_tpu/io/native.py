"""ctypes bindings for the native (C++) netCDF writer runtime.

`NativeNcWriter` mirrors `ncdf.NcWriter`'s interface but hands frames
to a background writer thread (native/ncwriter.cc) so the step loop
never blocks on disk. Falls back gracefully: `available()` is False if
the shared library is absent and cannot be built (g++ missing), and
callers keep using the scipy writer.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_NC_INT, _NC_FLOAT, _NC_DOUBLE = 4, 5, 6


def _lib_path():
    root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "native", "libqgncwriter.so")


def _stale(lib: str, src: str) -> bool:
    """True when the shared library is missing or older than its
    source, so a changed ncwriter.cc is never run from an old build."""
    if not os.path.exists(lib):
        return True
    return (os.path.exists(src)
            and os.path.getmtime(src) > os.path.getmtime(lib))


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    path = _lib_path()
    src = os.path.join(os.path.dirname(path), "ncwriter.cc")
    if _stale(path, src):
        if not os.path.exists(src):
            raise OSError("native writer source missing")
        # build beside the target, then rename: concurrent processes
        # never load a half-written library
        tmp = f"{path}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-pthread",
             "-std=c++17", "-o", tmp, src],
            check=True, capture_output=True)
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    lib.qgnc_create.argtypes = [ctypes.c_char_p]
    lib.qgnc_def_dim.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                 ctypes.c_int]
    lib.qgnc_def_var.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                 ctypes.c_int, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_int)]
    lib.qgnc_put_att_text.argtypes = [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_char_p, ctypes.c_char_p]
    lib.qgnc_enddef.argtypes = [ctypes.c_int]
    lib.qgnc_put.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p]
    lib.qgnc_put_async.argtypes = lib.qgnc_put.argtypes
    lib.qgnc_flush.argtypes = [ctypes.c_int]
    lib.qgnc_close.argtypes = [ctypes.c_int]
    _LIB = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


class NativeNcWriter:
    """Define-then-write netCDF3 writer backed by the C++ runtime.

    Unlike the scipy-backed NcWriter, variable definitions must all
    happen before the first data write (`_enddef` runs lazily on the
    first append/var-with-data)."""

    def __init__(self, path: str, async_io: bool = True):
        self.lib = _load()
        self.h = self.lib.qgnc_create(path.encode())
        if self.h < 0:
            raise OSError(f"cannot create {path}")
        self.dimids = {}
        self.varids = {}
        self.vdtype = {}
        self._defined = False
        self._pending = []          # (name, data) written after enddef
        self.async_io = async_io

    def dim(self, name: str, size):
        if name not in self.dimids:
            self.dimids[name] = self.lib.qgnc_def_dim(
                self.h, name.encode(), -1 if size is None else int(size))

    def var(self, name: str, dtype, dims, units=None, long_name=None,
            data=None):
        if dtype in ("d", np.float64):
            xt = _NC_DOUBLE
        elif dtype in ("i", np.int32):
            xt = _NC_INT
        else:
            xt = _NC_FLOAT
        ids = (ctypes.c_int * len(dims))(
            *[self.dimids[d] for d in dims])
        vid = self.lib.qgnc_def_var(self.h, name.encode(), xt,
                                    len(dims), ids)
        self.varids[name] = vid
        self.vdtype[name] = {_NC_DOUBLE: np.float64, _NC_INT: np.int32,
                             _NC_FLOAT: np.float32}[xt]
        if units is not None:
            self.lib.qgnc_put_att_text(self.h, vid, b"units",
                                       str(units).encode())
        if long_name is not None:
            self.lib.qgnc_put_att_text(self.h, vid, b"long_name",
                                       str(long_name).encode())
        if data is not None:
            self._pending.append((name, np.asarray(data)))

    def _enddef(self):
        if not self._defined:
            if self.lib.qgnc_enddef(self.h):
                raise OSError("enddef failed")
            self._defined = True
            for name, data in self._pending:
                self._put(name, 0, data)
            self._pending = []

    def _put(self, name, rec, value):
        a = np.ascontiguousarray(value, dtype=self.vdtype[name])
        fn = (self.lib.qgnc_put_async if self.async_io
              else self.lib.qgnc_put)
        fn(self.h, self.varids[name], int(rec),
           a.ctypes.data_as(ctypes.c_void_p))

    def append(self, name: str, rec: int, value):
        self._enddef()
        self._put(name, rec, value)

    def flush(self):
        self._enddef()
        self.lib.qgnc_flush(self.h)

    def close(self):
        self._enddef()
        self.lib.qgnc_close(self.h)
