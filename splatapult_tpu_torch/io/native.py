"""ctypes bindings for the native PLY codec (native/splatply.cpp in the repo).

The hot part of scene loading — de-interleaving a multi-hundred-MB vertex blob
into column arrays — runs in multi-threaded C++, mirroring how the reference
keeps its PLY layer native (ref: src/ply.cpp).

The library is built from ``native/splatply.cpp`` with the host's C++
compiler at first use, into ``_build/<hash of the source>/`` next to this
file (git-ignored); nothing checked in is loaded. Where there is no compiler
or no source (a package copied without the repo), or the build fails, the
numpy path runs instead, as in the JAX package. Which path runs is logged
once (logger ``splatapult_tpu_torch``).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile

import numpy as np

_log = logging.getLogger("splatapult_tpu_torch")

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "native", "splatply.cpp")
BUILD_ROOT = os.path.join(_HERE, "_build")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread", "-std=c++17"]

_TYPE_CODES = {
    np.dtype(np.float32): 0,
    np.dtype(np.float64): 1,
    np.dtype(np.uint8): 2,
    np.dtype(np.int32): 3,
}


class _Column(ctypes.Structure):
    _fields_ = [("src_offset", ctypes.c_int32), ("type", ctypes.c_int32)]


_lib = None
_tried = False
path_used = None  # "native" or "numpy" once the codec has been asked for


def _build() -> str:
    """Compile the source (once per source hash) -> the library's path."""
    with open(SOURCE, "rb") as f:
        src = f.read()
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + src).hexdigest()[:16]
    out_dir = os.path.join(BUILD_ROOT, digest)
    lib_path = os.path.join(out_dir, "libsplatply.so")
    if os.path.exists(lib_path):
        return lib_path
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise OSError("no C++ compiler (g++ / c++) on PATH")
    os.makedirs(out_dir, exist_ok=True)
    # build beside the target and rename: concurrent first uses never load a
    # half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True,
                             text=True, timeout=300)
        if res.returncode != 0:
            raise OSError(f"{cxx} failed: {res.stderr.strip()[-2000:]}")
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path


def _load():
    """The library, built at first call; None (numpy path) if it cannot be
    built or loaded."""
    global _lib, _tried, path_used
    if _tried:
        return _lib
    _tried = True
    try:
        if not os.path.exists(SOURCE):
            raise OSError(f"no source at {SOURCE}")
        lib = ctypes.CDLL(_build())
        lib.splatply_decode.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                                        ctypes.POINTER(_Column), ctypes.c_int32, ctypes.c_void_p]
        lib.splatply_decode.restype = None
        lib.splatply_version.restype = ctypes.c_int32
        if lib.splatply_version() != 1:
            raise OSError("unexpected splatply_version")
        _lib, path_used = lib, "native"
        _log.info("PLY codec: native library %s", lib._name)
    except (OSError, subprocess.SubprocessError) as e:
        _lib, path_used = None, "numpy"
        _log.info("PLY codec: numpy path (%s)", e)
    return _lib


def available() -> bool:
    """True when the native library is built and loaded (builds it at first
    call)."""
    return _load() is not None


def _columns_meta(vertices: np.ndarray, names):
    fields = vertices.dtype.fields
    cols = (_Column * len(names))()
    for i, name in enumerate(names):
        dt, offset = fields[name][0], fields[name][1]
        base = dt.newbyteorder("=")
        if base not in _TYPE_CODES or dt.byteorder == ">":
            return None  # unsupported layout -> numpy path
        cols[i].src_offset = offset
        cols[i].type = _TYPE_CODES[base]
    return cols


def decode_columns(vertices: np.ndarray, names) -> np.ndarray:
    """Structured array -> [N, len(names)] float32 (native if possible)."""
    lib = _load()
    if lib is not None and vertices.flags["C_CONTIGUOUS"]:
        cols = _columns_meta(vertices, names)
        if cols is not None:
            n = vertices.shape[0]
            out = np.empty((n, len(names)), np.float32)
            lib.splatply_decode(vertices.ctypes.data, n, vertices.dtype.itemsize,
                                cols, len(names), out.ctypes.data)
            return out
    return np.stack([vertices[nm].astype(np.float32) for nm in names], axis=-1)
