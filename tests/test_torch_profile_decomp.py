"""The stage functions behind the port's tools/profile_bin.py and
tools/profile_bwd.py, on the CPU, against the whole functions and the JAX
package.

bin_splats and per_splat_sums run their stages through binning.run_stage
(binning._bin_stages, composite._tail_stages), which records each stage with
the inputs it got, so that the profilers time the code that ships. Here the
recorded run must give the whole function's outputs bit for bit, each stage
replayed alone (profile_bin.stage_calls) must give what it gave there, the
bins must equal the JAX package's bin_splats bit for bit (integer plumbing;
its Pallas expand kernel in interpret mode), and the tail the JAX package's
_cff_bwd tail within 2e-4 of each column's largest magnitude (4e-3 with
bf16 columns), the tolerances of the port's other gradient tests.
The inputs are seeded numpy arrays: 2000 splats over a 128x64 image.

Also: the tools' ball scene is the JAX repo's bench.make_scene array for
array, and each tool exits non-zero on a machine without a CUDA device.

The JAX references are jitted once per module, compiled in threads.
"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from splatapult_tpu.ops import binning as jb, composite as jc

from splatapult_tpu_torch.ops import binning as tb, composite as tc
from splatapult_tpu_torch.tools import profile_bin, scenes

# One thread for torch: the suite runs several worker processes per machine,
# and an oversubscribed intra-op thread pool slows every worker down.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, W, H = 2000, 128, 64
GRID_KW = dict(width=W, height=H, num_splats=N, tile_size=16, block=8)
# (grid knobs, row_offset): row ownership absent and set, the 20-bit key, and
# a capacity the view overflows (whole farthest splats dropped)
BIN_CASES = {
    "exact": (dict(max_instance_mult=4.0), None),
    "row_offset": (dict(max_instance_mult=4.0, row_stride=2), 1),
    "depth20": (dict(max_instance_mult=4.0, depth_bits=20), None),
    "overflow": (dict(max_instance_mult=0.5, tile_size=8), None),
}
BIN_STAGES = ["rects+counts", "overflow drop", "table cumsums", "expand fill (B1)",
              "slot columns", "tile histogram", "alignment pads", "sort key",
              "main sort", "block metadata"]
TAIL_STAGES = ["tail/id sort", "tail/column gather", "tail/two-level prefix sum",
               "tail/segment ends + difference"]
COMPARED = ("inst_splat", "block_meta", "seg_offs", "seg_cnt", "block_tile",
            "block_first", "block_live", "tile_ok", "tile_count", "num_culled_instances")


def _splats():
    """Seeded screen-space splats: centres a little past the image's edges,
    a tenth culled (zero extent), depths with ties."""
    rng = np.random.default_rng(7)
    mean2d = np.stack([rng.uniform(-8, W + 8, N), rng.uniform(-8, H + 8, N)], 1)
    extent = rng.uniform(0.5, 10.0, (N, 2))
    extent[rng.uniform(size=N) < 0.1] = 0.0
    depth = np.round(rng.uniform(0.5, 10.0, N), 2)
    return {k: v.astype(np.float32) for k, v in
            (("mean2d", mean2d), ("extent", extent), ("depth", depth))}


def _same(a, b) -> bool:
    """Bit for bit equal: tensors, and tuples and dicts of them."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def _replay(record):
    """Each recorded stage run again alone on the inputs it got -> the names
    of those whose result differs from what the stage gave in the run."""
    calls = profile_bin.stage_calls(record)
    return [name for name, _, _, got in record if not _same(calls[name](), got)]


def _jax_tail(grid):
    """The tail of the JAX package's _cff_bwd on given per-instance columns,
    jitted -> (d_inst, bins) -> [N + 1, 16]. Traced only while its _bwd_call
    is stood in for by the columns themselves (passed as the residuals'
    instance rows)."""
    return jax.jit(lambda d_inst, bins: jc._cff_bwd(grid, (d_inst, bins, None), None)[0])


@pytest.fixture(scope="module")
def ref():
    """The JAX package's bins for every case, and its tail in f32 and with
    bf16 columns on random columns over the exact case's bins: compiled in
    threads, each once."""
    s = _splats()
    args = {k: jnp.asarray(v) for k, v in s.items()}
    bin_jit = jax.jit(jb.bin_splats, static_argnames=("grid", "row_offset"))

    def jax_bins(case):
        knobs, row_offset = BIN_CASES[case]
        out = bin_jit(args["mean2d"], args["extent"],
                      grid=jb.TileGrid.create(**{**GRID_KW, **knobs}), depth=args["depth"],
                      row_offset=row_offset)
        return {k: np.array(v) for k, v in out.items()}

    with ThreadPoolExecutor(len(BIN_CASES)) as pool:
        bins = dict(zip(BIN_CASES, pool.map(jax_bins, BIN_CASES)))
    exact = bins["exact"]
    grid_kw = {**GRID_KW, **BIN_CASES["exact"][0]}
    mcap = tb.TileGrid.create(**grid_kw).mcap
    d_inst = np.random.default_rng(2).standard_normal((tc.NUM_GRAD_COLS, mcap)).astype(np.float32)
    d_inst[:, exact["inst_splat"] == N] = 0.0  # null and padding slots carry zeros

    def jax_tail(dtype):
        fn = _jax_tail(jb.TileGrid.create(**grid_kw, grad_sort_dtype=dtype))
        return np.asarray(fn(jnp.asarray(d_inst), {k: jnp.asarray(v) for k, v in exact.items()}))

    # one patch around both traces: mock.patch is not thread-safe, and entered
    # in each thread it can leave the stand-in in the module for good
    real = jc._bwd_call
    with mock.patch.object(jc, "_bwd_call", lambda inst, *args: inst):
        with ThreadPoolExecutor(2) as pool:
            tails = dict(zip(("float32", "bfloat16"),
                             pool.map(jax_tail, ("float32", "bfloat16"))))
    assert jc._bwd_call is real
    return {"splats": s, "bins": bins, "d_inst": d_inst, "tails": tails, "grid_kw": grid_kw}


@pytest.mark.parametrize("case", list(BIN_CASES))
def test_bin_stages_compose_to_bin_splats_and_match_jax(ref, case):
    knobs, row_offset = BIN_CASES[case]
    grid = tb.TileGrid.create(**{**GRID_KW, **knobs})
    args = [torch.from_numpy(ref["splats"][k]) for k in ("mean2d", "extent", "depth")]
    record = []
    composed = tb._bin_stages(args[0], args[1], grid, args[2], row_offset, record)
    whole = tb.bin_splats(args[0], args[1], grid, args[2], row_offset=row_offset)
    want = ref["bins"][case]
    assert sorted(composed) == sorted(whole) == sorted(COMPARED)
    for k in COMPARED:
        assert torch.equal(composed[k], whole[k]), k
        a = whole[k].numpy()
        assert a.dtype == want[k].dtype and a.shape == want[k].shape, k
        np.testing.assert_array_equal(a, want[k], err_msg=k)
    culled = int(whole["num_culled_instances"])
    assert (culled > 0) == (case == "overflow")
    outs = {name: got for name, _, _, got in record}
    assert int(whole["tile_count"].sum()) == int(outs["table cumsums"]["ends"][-1]) > N // 2
    # the stages the profiler times, each alone on the inputs it got, as shipped
    assert [name for name, *_ in record] == BIN_STAGES
    assert torch.equal(outs["main sort"][1], whole["inst_splat"])
    assert torch.equal(outs["block metadata"][0], whole["block_tile"])
    assert _replay(record) == []


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tail_stages_compose_to_per_splat_sums_and_match_jax(ref, dtype):
    grid = tb.TileGrid.create(**ref["grid_kw"], grad_sort_dtype=dtype)
    bins = {k: torch.from_numpy(v) for k, v in ref["bins"]["exact"].items()}
    args = (torch.from_numpy(ref["d_inst"]), bins["inst_splat"], bins["seg_offs"],
            bins["seg_cnt"], grid)
    record = []
    composed = tc._tail_stages(*args, record=record)
    whole = tc.per_splat_sums(*args)
    assert torch.equal(composed, whole)
    assert [name for name, *_ in record] == TAIL_STAGES
    cols = record[1][3]
    assert cols.shape == (tc.NUM_GRAD_COLS, grid.emax) and cols.dtype == torch.float64
    assert _replay(record) == []
    got, want = whole.numpy(), ref["tails"][dtype]
    assert got.shape == want.shape == (N + 1, tc.NUM_FEATS)
    scale = np.abs(want[:, :9]).max(axis=0)
    tol = 2e-4 if dtype == "float32" else 4e-3
    assert (scale > 1.0).all()
    assert (np.abs(got[:, :9] - want[:, :9]) <= tol * scale).all(), (
        (np.abs(got[:, :9] - want[:, :9]) / scale).max(axis=0))
    assert (got[:, 9:] == 0).all() and (got[N] == 0).all()
    # splats with no instance: exactly zero on both sides
    empty = bins["seg_cnt"].numpy() == 0
    assert empty.sum() > 50 and (got[:N][empty] == 0).all() and (want[:N][empty] == 0).all()


def test_ball_scene_is_bench_make_scene():
    sys.path.insert(0, ROOT)
    try:
        from bench import make_scene as jmake_scene
    finally:
        sys.path.remove(ROOT)
    want = jmake_scene(1000, seed=3)
    got = scenes.make_bench_scene("ball", 1000, seed=3, device="cpu")
    for name in ("means", "sh", "opacities", "log_scales", "quats"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert scenes.bench_camera("ball", 64, 32, device="cpu").proj.shape == (4, 4)


@pytest.fixture(scope="module")
def tool_runs():
    """Both tools run with ``python -m`` at once, with no CUDA device visible
    (a 120 s timeout each) -> tool -> (exit code, stdout, stderr)."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    procs = {tool: subprocess.Popen(
        [sys.executable, "-m", f"splatapult_tpu_torch.tools.{tool}", "--splats", "1000"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for tool in ("profile_bin", "profile_bwd")}
    runs = {}
    for tool, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=120)
        finally:
            proc.kill()
        runs[tool] = (proc.returncode, out, err)
    return runs


@pytest.mark.parametrize("tool", ["profile_bin", "profile_bwd"])
def test_tool_exits_non_zero_without_a_cuda_device(tool_runs, tool):
    code, out, err = tool_runs[tool]
    assert code != 0
    assert out == ""
    assert f"{tool}: no CUDA device" in err
