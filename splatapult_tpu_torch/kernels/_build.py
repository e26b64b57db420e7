"""Build csrc/*.cu with nvcc into one shared library and bind it with ctypes.

The library is built at first use, from the sources next to this file and
nothing else, into ``_build/<hash of the sources>/`` (git-ignored), so an edit
to any source rebuilds. Each source compiles to an object in its own nvcc
process (all started together); one link step makes ``libsplat_kernels.so``.
A failed build raises with nvcc's output. The C interface takes raw device
pointers and the CUDA stream as ``void*`` and returns the launch's
``cudaGetLastError()`` code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_ROOT = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]
COMPILE_FLAGS = ["-Xptxas", "-v"]  # registers, shared memory, spills -> last_build_log

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# name -> argtypes (every pointer and the stream are c_void_p: ctypes would
# otherwise pass a Python int as a 32-bit int and cut the pointer)
SIGNATURES = {
    # ends, tile0, nx, dbits, out, n, emax, row_step, stream
    "splat_expand_fill": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    # inst, tile_start, tile_nblk, locs, num_segments, seg_blocks, num_tiles,
    # tiles_x, tile_size, height, block, ln_cutoff, use_cutoff, layout,
    # mean_step_x, mean_step_y, mean_off_x, mean_off_y, stream
    "splat_composite_fwd_segments": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I,
                                     _I, _F, _F, _F, _F, _P],
    # inst, tile_start, tile_nblk, locs, out, tile_walked, store_prefix,
    # seg_blocks, num_tiles, tiles_x, tile_size, height, block, ln_cutoff,
    # use_cutoff, early_stop_eps, layout, mean_step_x, mean_step_y,
    # mean_off_x, mean_off_y, rows_bf16, stream
    "splat_composite_fwd_combine": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                    _F, _I, _F, _I, _F, _F, _F, _F, _I, _P],
    # inst, tile_start, tile_walked, ckpt, out_res, dout, d_inst,
    # num_segments, seg_blocks, num_tiles, mcap, tiles_x, tile_size, height,
    # block, ln_cutoff, use_cutoff, layout, mean_step_x, mean_step_y,
    # mean_off_x, mean_off_y, rows_bf16, stream
    "splat_composite_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I, _I, _I, _F, _I, _I, _F, _F, _F, _F, _I, _P],
}

_lib = None
last_build_seconds = None  # wall time of the build this process ran, if any
last_build_log = ""  # nvcc's output from that build (ptxas -v statistics)


def sources() -> list:
    return sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
        if f.endswith((".cu", ".cuh")))


def _source_hash(paths) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME, $CUDA_PATH and "
        "/usr/local/cuda): the CUDA kernels cannot be built")


def _run_all(cmds) -> str:
    """Start every command at once, wait for all -> their combined output;
    raises with the compiler's output if any failed."""
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True))
        for cmd in cmds
    ]
    failures, log = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n{out}")
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return "".join(log)


def build() -> str:
    """Compile the sources if their hash has no library yet -> library path."""
    global last_build_seconds, last_build_log
    srcs = sources()
    cu = [p for p in srcs if p.endswith(".cu")]
    if not cu:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    out_dir = os.path.join(BUILD_ROOT, _source_hash(srcs))
    lib_path = os.path.join(out_dir, "libsplat_kernels.so")
    if os.path.isfile(lib_path):
        return lib_path
    nvcc = _find_nvcc()
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    # build in a private directory and rename into place, so a concurrent or
    # interrupted build never leaves a half-written library behind
    work = tempfile.mkdtemp(prefix="build-", dir=out_dir)
    try:
        objs = [os.path.join(work, os.path.basename(p)[:-3] + ".o") for p in cu]
        log = _run_all([[nvcc, *NVCC_FLAGS, *COMPILE_FLAGS, "-I", CSRC_DIR, "-c", src, "-o", obj]
                        for src, obj in zip(cu, objs)])
        tmp_lib = os.path.join(work, "libsplat_kernels.so")
        log += _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp_lib, *objs]])
        os.replace(tmp_lib, lib_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    last_build_seconds = time.perf_counter() - t0
    last_build_log = log
    return lib_path


def load() -> ctypes.CDLL:
    """Build if needed, load once per process, declare every signature."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_launch(code: int, name: str) -> None:
    """Raise when a kernel launch returned a non-zero CUDA error code."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")
