"""Build csrc/*.cu with nvcc into two shared libraries and bind them with ctypes.

``libsplat_kernels.so`` holds the kernels of the render and training paths
(``expand.cu``, ``composite_fwd.cu``, ``composite_bwd.cu``); ``libsplat_tools.so``
the diagnostic kernels that only the tools under ``tools/`` launch (the
ablation variants, ``composite_*_ablate.cu``, and the scatter and gather
probes, ``probe_*.cu``), so a render user never compiles them. Each library is
built at first use, from its own ``.cu`` files and every header next to them,
into ``_build/<hash of those sources>/`` (git-ignored), so an edit to any of
them rebuilds it. Each source compiles to an object in its own nvcc process
(all started together, those of both libraries when both are built at once);
one link step a library. A failed build raises with nvcc's output. The C
interface takes raw device pointers and the CUDA stream as ``void*`` and
returns the launch's ``cudaGetLastError()`` code.
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
COMPILE_FLAGS = ["-Xptxas", "-v"]  # registers, shared memory, spills -> last_build_logs

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
# the tools library: the ablation microbenchmark's variants and the probes
TOOL_SIGNATURES = {
    # the ablation microbenchmark's variants (f32x16 rows, f32 output rows):
    # variant, seg_blocks, inst, tile_start, tile_nblk, locs, num_segments,
    # num_tiles, tiles_x, tile_size, height, block, ln_cutoff, use_cutoff,
    # stream
    "splat_ablate_fwd_segments": [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I,
                                  _P],
    # variant, seg_blocks, inst, tile_start, tile_nblk, locs, out,
    # tile_walked, store_prefix, num_tiles, tiles_x, tile_size, height, block,
    # ln_cutoff, use_cutoff, early_stop_eps, stream
    "splat_ablate_fwd_combine": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 _F, _I, _F, _P],
    # variant, inst, tile_start, tile_walked, ckpt, out_res, dout, d_inst,
    # num_segments, num_tiles, mcap, tiles_x, tile_size, height, block,
    # ln_cutoff, use_cutoff, stream
    "splat_ablate_bwd": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I,
                         _P],
    # rows, dest, out, blocks, block_rows, quads (16-byte parts of a row), stream
    "splat_probe_scatter_rows": [_P, _P, _P, _I, _I, _I, _P],
    # rows, cdest, out, blocks, block_rows (chunks of 128 rows), quads, stream
    "splat_probe_scatter_chunks": [_P, _P, _P, _I, _I, _I, _P],
    "splat_probe_scatter_half_chunks": [_P, _P, _P, _I, _I, _I, _P],
    # x, idx, out, rows, x_cols, idx_cols, route (0 direct, 1 staged), stream
    "splat_probe_gather_lane": [_P, _P, _P, _I, _I, _I, _I, _P],
    # x, idx, out, x_rows, cols, idx_rows, stream
    "splat_probe_gather_sub": [_P, _P, _P, _I, _I, _I, _P],
    # stream: an empty kernel, the probes' launch floor
    "splat_probe_empty": [_P],
}
SHIPPED, TOOLS = "splat_kernels", "splat_tools"
# library -> (its .cu sources, its C functions); every .cuh is hashed into both
LIBRARIES = {
    SHIPPED: (("composite_bwd.cu", "composite_fwd.cu", "expand.cu"), SIGNATURES),
    TOOLS: (("composite_bwd_ablate.cu", "composite_fwd_ablate.cu", "probe_gather.cu",
             "probe_scatter.cu"), TOOL_SIGNATURES),
}

_libs = {}  # library -> its loaded ctypes.CDLL
last_build_seconds = None  # wall time of the last build this process ran, if any
last_build_logs = {}  # source -> nvcc's output for it in that build (ptxas -v statistics)


def sources(library: str) -> list:
    """The library's .cu files and every header: what its hash covers."""
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith(".cuh") or f in LIBRARIES[library][0])


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


def _run_all(cmds) -> list:
    """Start every command at once, wait for all -> each one's output; raises
    with the compiler's output if any failed."""
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
    return log


def build(*libraries: str) -> dict:
    """Compile the named libraries (default: the shipped one) whose sources
    have no library yet, every source in its own nvcc process, all started
    together -> library -> path."""
    global last_build_seconds, last_build_logs
    paths = {lib: os.path.join(BUILD_ROOT, _source_hash(sources(lib)), f"lib{lib}.so")
             for lib in (libraries or (SHIPPED,))}
    todo = [lib for lib, path in paths.items() if not os.path.isfile(path)]
    if not todo:
        return paths
    nvcc = _find_nvcc()
    t0 = time.perf_counter()
    # build in private directories and rename into place, so a concurrent or
    # interrupted build never leaves a half-written library behind
    works = {}
    try:
        for lib in todo:
            os.makedirs(os.path.dirname(paths[lib]), exist_ok=True)
            works[lib] = tempfile.mkdtemp(prefix="build-", dir=os.path.dirname(paths[lib]))
        objs = {lib: [os.path.join(works[lib], f[:-3] + ".o") for f in LIBRARIES[lib][0]]
                for lib in todo}
        jobs = [(f, o) for lib in todo for f, o in zip(LIBRARIES[lib][0], objs[lib])]
        logs = _run_all([[nvcc, *NVCC_FLAGS, *COMPILE_FLAGS, "-I", CSRC_DIR, "-c",
                          os.path.join(CSRC_DIR, f), "-o", o] for f, o in jobs])
        tmp_libs = {lib: os.path.join(works[lib], os.path.basename(paths[lib])) for lib in todo}
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp_libs[lib], *objs[lib]]
                  for lib in todo])
        for lib in todo:
            os.replace(tmp_libs[lib], paths[lib])
    finally:
        for work in works.values():
            shutil.rmtree(work, ignore_errors=True)
    last_build_seconds = time.perf_counter() - t0
    last_build_logs = {f: log for (f, _), log in zip(jobs, logs)}
    return paths


def load(library: str = SHIPPED) -> ctypes.CDLL:
    """Build if needed, load once per process, declare every signature."""
    if library not in _libs:
        lib = ctypes.CDLL(build(library)[library])
        for name, argtypes in LIBRARIES[library][1].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[library] = lib
    return _libs[library]


def check_launch(code: int, name: str) -> None:
    """Raise when a kernel launch returned a non-zero CUDA error code."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")
