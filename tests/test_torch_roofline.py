"""The port's tools/roofline.py and tools/scaling_model.py (in
splatapult_tpu_torch/tools/) on the CPU, against the JAX repo's tools of the
same names.

The JAX side is the JAX tools themselves, their main() run in this process
with their stdout captured (tools/roofline.py --splats 20000;
tools/scaling_model.py --splats 20000 --chips 1 2 4 with its phase_model
replaced by a recorder of fixed per-phase seconds, so that its efficiency
table can be recomputed from the same seconds), and one jitted program of
the JAX package's band_instance_demands for D = 1, 2, 4 (the function the
JAX model calls). They run in a thread while the port computes, and the two
CLIs run in processes of their own beside both.

Held here, on the garden stand-in's 20,000 splats and bench.py's 1080p view:
- the roofline's geometry line (demand, emax, mcap, blocks, pairs) equal to
  the JAX tool's first line, character for character;
- the port's curve interpolation, step lookup and radix_sort_s, fed the JAX
  tool's own _SORT_CURVE, gather steps (tools/roofline.py:67-72) and HBM
  rate, equal to the JAX functions over a sweep of row counts (the JAX
  radix_sort_s is a function inside its main(): it is compiled here from
  that source);
- the kernel rows equal to profile_phases.composite_bounds on the same
  binning, every row positive, each total the sum of its rows;
- for D = 1, 2, 4, at the JAX model's exact capacity (bucket 1): the
  per-band demands equal to the JAX package's, and the peak, beta, emax,
  mcap and mult equal to the JAX model's lines;
- the efficiency arithmetic, given the JAX model's per-phase seconds, its
  table number for number; the collectives' formulas at its ICI rate;
- the port's model priced on a step's measured stages: each phase at D = 1
  its stage, at D = 2 its stage scaled as its floor, the prepare its time
  measured on N / D splats, the prepare's VJP the SH all-reduce's window;
- both CLIs on --device cpu exit 0 and end in a JSON line (at 2,000 splats:
  the plain walk of the touched pairs is what costs on the CPU); without
  --device cpu they raise here, where there is no card;
- neither module imports JAX or holds a TPU rate of the JAX tools.
"""

import ast
import contextlib
import importlib
import inspect
import io
import json
import math
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import jax
import pytest
import torch

from splatapult_tpu_torch.ops import binning as tb, composite as tc
from splatapult_tpu_torch.tools import roofline as RL, scaling_model as SM, scenes
from splatapult_tpu_torch.tools.profile_phases import composite_bounds

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, W, H, CHIPS = 20000, 1920, 1080, (1, 2, 4)
CLI_SPLATS, CLI_TIMEOUT_S = 2000, 120
# tools/roofline.py:67-72, gather_ns_idx's steps: (largest table rows, s/idx)
JAX_GATHER_STEPS = [(1.4e6, 3.4e-9), (2.7e6, 4.7e-9), (math.inf, 7.0e-9)]
# the JAX tools' TPU rates, none of which may appear in the port
JAX_TPU_RATES = ("819e9", "3.85e12", "197e12", "0.41", "0.67", "90e9", "0.589e-9", "4.5e-9",
                 "0.6e-3")


def _stub_phase_model(record):
    """A stand-in for the JAX model's phase_model: fixed seconds a phase by
    capacity (the AR terms visible against them), each dict recorded; the
    JAX main adds the prepare and the collectives into the same dict."""
    def phase_model(n, emax, mcap, tiles, block, tile_px, main_ops=1):
        t = {"binning": 2e-9 * mcap, "gather": 1e-9 * mcap, "fwd kernel": 1e-9 * mcap,
             "bwd kernel": 1e-10 * mcap, "bwd tail": 1e-10 * emax}
        record.append(t)
        return t
    return phase_model


def _run_main(main, argv):
    out = io.StringIO()
    with mock.patch.object(sys, "argv", argv), contextlib.redirect_stdout(out):
        main()
    return out.getvalue().splitlines()


def _jax_side():
    import tools.roofline as jrl
    import tools.scaling_model as jsm
    from bench import make_bench_scene
    from splatapult_tpu.io.synth import garden_cameras
    from splatapult_tpu.parallel.mesh import band_instance_demands

    jr = importlib.import_module("splatapult_tpu.render")  # the package re-exports render()
    roofline_lines = _run_main(jrl.main, ["roofline.py", "--splats", str(N)])
    record = []
    with mock.patch.object(jsm, "phase_model", _stub_phase_model(record)):
        scaling_lines = _run_main(jsm.main, ["scaling_model.py", "--splats", str(N), "--chips",
                                             *map(str, CHIPS)])
    cfg = jr.RenderConfig(width=W, height=H, pipeline="tiled", tile_size=32, tile_block=128)
    bands = jax.jit(lambda s, c: {d: band_instance_demands(s, c, cfg, d, "interleaved")
                                  for d in CHIPS})(make_bench_scene("garden", N),
                                                   garden_cameras(1, width=W, height_px=H))
    return {"jrl": jrl, "jsm": jsm, "roofline": roofline_lines, "scaling": scaling_lines,
            "phases": record, "bands": {d: [int(x) for x in b] for d, b in bands.items()}}


def _cli(tool, *args):
    return subprocess.Popen(
        [sys.executable, "-m", f"splatapult_tpu_torch.tools.{tool}", "--device", "cpu",
         "--splats", str(CLI_SPLATS), *args], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=dict(os.environ, OMP_NUM_THREADS="1"))


@pytest.fixture(scope="module")
def ref():
    clis = {"roofline": _cli("roofline", "--measured-ms", "20"),
            "scaling_model": _cli("scaling_model", "--chips", "1", "2")}
    try:
        with ThreadPoolExecutor(1) as pool:
            jax_future = pool.submit(_jax_side)
            R = importlib.import_module("splatapult_tpu_torch.render")
            scene = scenes.make_bench_scene("garden", N, device="cpu")
            cam = scenes.bench_camera("garden", W, H, device="cpu")
            base = R.RenderConfig(width=W, height=H, pipeline="tiled", forward_only=False)
            cfg = R.calibrate_config(scene, cam, base)
            port = {"scene": scene, "cam": cam, "base": base, "cfg": cfg,
                    "roofline": RL.roofline(scene, cam, cfg),
                    "capacity": {d: SM.band_capacity(scene, cam, base, d, "interleaved", 1.0)
                                 for d in CHIPS}}
            jax_ref = jax_future.result()
        done = {k: p.communicate(timeout=CLI_TIMEOUT_S) + (p.returncode,)
                for k, p in clis.items()}
    finally:
        for p in clis.values():
            if p.poll() is None:
                p.kill()
                p.wait(10)
    return {"port": port, "jax": jax_ref, "clis": done}


def test_geometry_line_matches_the_jax_tool(ref):
    port, jax_lines = ref["port"], ref["jax"]["roofline"]
    assert RL.geometry_line("garden", N, port["roofline"]["geometry"]) == jax_lines[0]
    assert port["roofline"]["capacity"]["emax"] == tb.TileGrid.create(
        width=W, height=H, num_splats=N, max_instance_mult=port["cfg"].max_instance_mult).emax
    assert port["roofline"]["capacity"]["culled"] == 0


@pytest.mark.parametrize("rows", [1e5, 1.33e6, 1.5e6, 2.0e6, 2.66e6, 3.9e6, 5.32e6, 8e6,
                                  10.64e6, 2e7])
def test_curves_and_radix_floor_match_the_jax_functions(ref, rows):
    jrl = ref["jax"]["jrl"]
    assert RL.sort_ns_row_op(rows, jrl._SORT_CURVE) == jrl.sort_ns_row_op(rows)
    assert RL.gather_ns_idx(rows, JAX_GATHER_STEPS) == jrl.gather_ns_idx(rows)
    # tools/roofline.py's radix_sort_s lives inside its main(): compile it
    main_src = ast.parse(inspect.getsource(jrl.main))
    fn = next(n for n in ast.walk(main_src)
              if isinstance(n, ast.FunctionDef) and n.name == "radix_sort_s")
    ns = {"math": math, "HBM_GBS": jrl.HBM_GBS}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), jrl.__file__, "exec"), ns)
    for op_bytes, bits in ((8, 11), (12, 43), (24, 15), (8, 32)):
        assert RL.radix_sort_s(rows, op_bytes, bits, jrl.HBM_GBS) == ns["radix_sort_s"](
            rows, op_bytes, bits)


def test_rows_are_the_kernel_bounds_and_add_up(ref):
    port = ref["port"]
    res, cfg = port["roofline"], port["cfg"]
    v = RL.view_inputs(port["scene"], port["cam"], cfg)
    # exact: no early stop, the forward walks every block of every tile
    bounds = composite_bounds(v["inst"], v["start"], tc.Segments(ckpt=None, walked=v["seg"].walked),
                              v["grid"], 4)
    rows = {r["name"]: r for r in res["rows"]}
    assert rows["fwd kernel"]["s"] * 1e3 == bounds["composite_fwd"]["bound_ms"]
    assert rows["bwd kernel"]["s"] * 1e3 == bounds["composite_bwd"]["bound_ms"]
    assert all(r["s"] > 0 and r["radix_s"] > 0 and r["bytes"] > 0 for r in res["rows"])
    assert all(r["radix_s"] <= r["s"] for r in res["rows"])
    t = res["totals"]
    assert math.isclose(t["measured_rate_floor_ms"], 1e3 * sum(r["s"] for r in res["rows"]))
    assert math.isclose(t["radix_bytes_floor_ms"], 1e3 * sum(r["radix_s"] for r in res["rows"]))
    assert t["frame_floor_ms"] < t["measured_rate_floor_ms"]
    assert [r["name"] for r in res["rows"]][:5] == [
        "binning (sorts+expand)", "instance gather", "fwd kernel", "bwd kernel", "backward tail"]


def test_band_capacities_match_the_jax_model(ref):
    port, jx = ref["port"], ref["jax"]
    lines = [ln for ln in jx["scaling"] if ln.startswith("D=")]
    assert len(lines) == len(CHIPS)
    for d, line in zip(CHIPS, lines):
        cap = port["capacity"][d]
        assert cap["bands"] == jx["bands"][d]
        got = (f"D={d}: peak_band={cap['peak']} beta={cap['beta']:.3f} emax={cap['emax']} "
               f"mcap={cap['mcap']} mult={cap['mult']:.3f}")
        assert got == line
        assert cap["beta"] == cap["peak"] * d / sum(jx["bands"][d])


def test_efficiency_arithmetic_matches_the_jax_table(ref):
    jx = ref["jax"]
    jsm, phases, lines = jx["jsm"], jx["phases"], jx["scaling"]
    assert len(phases) == len(CHIPS)
    per_d = {}
    for d, t in zip(CHIPS, phases):
        if d > 1:  # the JAX model's collectives, by the port's formulas at its ICI rate
            assert math.isclose(t["prep all-gather"], SM.allgather_s(
                N * SM.PREP_FLOATS * 4, d, jsm.ICI_GBS), rel_tol=1e-12)
        t_ar = SM.ring_allreduce_s(N * SM.GRAD_FLOATS * 4, d, jsm.ICI_GBS)
        compute = sum(t.values())
        per_d[d] = {"compute": compute,
                    "ar_hidden": max(0.0, t_ar - t["bwd kernel"] - t["bwd tail"]),
                    "ar_exposed": t_ar if d > 1 else 0.0, "zero": compute}
    rows = SM.efficiency_rows(list(CHIPS), per_d)
    at = lines.index("efficiency vs D=1 (total work fixed at one view):")
    assert lines[at + 1].split() == SM.table_lines(rows)[0].split()
    for row, line in zip(rows, lines[at + 2:at + 2 + len(CHIPS)]):
        d, th, eh, tx, ex, tz, ez = row
        assert line.split() == [str(d), f"{th * 1e3:.1f}ms", f"{eh:.1%}", f"{tx * 1e3:.1f}ms",
                                f"{ex:.1%}", f"{tz * 1e3:.1f}ms", f"{ez:.1%}"]
    assert rows[1][2] != rows[1][4]  # the all-reduce shows in the table


def test_port_model_calibrates_as_calibrate_config_sharded(ref):
    from splatapult_tpu_torch.parallel import mesh as PM

    port = ref["port"]
    for d in CHIPS:
        cal = PM.calibrate_config_sharded(port["scene"], port["cam"], port["base"],
                                          {"tiles": d}, bucket=1.0)
        grid = PM._band_grid(cal, N, d)
        cap = port["capacity"][d]
        assert (cap["emax"], cap["mcap"], cap["mult"]) == (grid.emax, grid.mcap,
                                                          cal.max_instance_mult)


def test_model_priced_on_measured_stages(ref):
    """Priced on a step's stages (calibration against the one-card floors),
    each phase is its stage where the floors are the one-card floors, and
    its stage times its floor's ratio where they are not; the prepare is its
    measured time at the band's splat count; the prepare's VJP is the window
    the SH all-reduce can hide in, on stages and on floors."""
    port = ref["port"]
    floors = SM.phase_floors(port["scene"], port["cam"], port["capacity"][2])
    stage_src = inspect.getsource(RL.measure_stages)
    stages = {floors["stage"][k]: 3e3 * s + 0.5 for k, s in floors["s"].items()}
    stages.update({SM.PREPARE_FWD_STAGE: 4.0, SM.PREPARE_STAGE: 10.0})
    assert all(f'"{name}"' in stage_src for name in stages)
    cal = SM.calibration(floors, {"stages_ms": stages,
                                  "prepare_ms_by_splats": {N // 2: 7.0, N: 10.0}})
    one = SM.phase_model(floors, N, 1, True, cal)
    for k, stage in floors["stage"].items():
        assert math.isclose(one["t"][k] * 1e3, stages[stage], rel_tol=1e-12)
    assert math.isclose(one["t"]["prepare"] * 1e3, 10.0, rel_tol=1e-12)
    assert math.isclose(one["prepare_vjp"] * 1e3, 6.0, rel_tol=1e-12)
    assert math.isclose(sum(one["t"].values()) * 1e3, sum(stages.values()) - 4.0, rel_tol=1e-12)
    half = {**floors, "s": {k: s / 2 for k, s in floors["s"].items()}}
    two = SM.phase_model(half, N, 2, True, cal)
    for k, stage in floors["stage"].items():
        assert math.isclose(two["t"][k] * 1e3, stages[stage] / 2, rel_tol=1e-12)
    assert math.isclose(two["t"]["prepare"] * 1e3, 7.0, rel_tol=1e-12)
    assert math.isclose(two["prepare_vjp"] * 1e3, 7.0 * 0.6, rel_tol=1e-12)
    assert two["t"]["prep all-gather"] == two["t"]["feat grad-scatter"] > 0
    assert math.isclose(two["zero"], sum(two["t"].values()) - two["t"]["adam"] / 2,
                        rel_tol=1e-12)
    bare = SM.phase_model(floors, N, 2, True)
    assert 0 < floors["prepare_fwd_share"] < 1
    assert bare["t"] == {**floors["s"], "prepare": SM.prepare_s(N / 2),
                         "prep all-gather": two["t"]["prep all-gather"],
                         "feat grad-scatter": two["t"]["feat grad-scatter"]}
    assert math.isclose(bare["prepare_vjp"], bare["t"]["prepare"] * (1 - floors["prepare_fwd_share"]))


def test_prepare_price_and_collectives():
    pts = SM.PREPARE_FWD_VJP_MS
    assert all(math.isclose(SM.prepare_s(n) * 1e3, ms) for n, ms in pts)
    assert SM.prepare_s(pts[0][0] / 2) < SM.prepare_s(pts[0][0]) < SM.prepare_s(pts[-1][0] * 2)
    assert SM.ring_allreduce_s(1e9, 1) == 0.0 == SM.allgather_s(1e9, 1)
    assert SM.ring_allreduce_s(1e9, 4) == 2 * SM.allgather_s(1e9, 4)


@pytest.mark.parametrize("tool", ["roofline", "scaling_model"])
def test_clis_on_the_cpu_end_in_a_json_line(ref, tool):
    out, err, code = ref["clis"][tool]
    assert code == 0, err[-3000:]
    last = json.loads(out.strip().splitlines()[-1])
    assert last["tool"] == tool and last["device"] == "cpu" and last["splats"] == CLI_SPLATS
    if tool == "roofline":
        assert out.splitlines()[0].startswith(f"scene=garden n={CLI_SPLATS} demand=")
        assert last["shares"]["measured_rate_floor_ms"] == (
            last["totals"]["measured_rate_floor_ms"] / 20.0)
        assert "% of the measured-rate model" in out
    else:
        assert set(last["per_d"]) == {"1", "2"} and "(ASSUMED)" in out
        assert "ONE rank" in out
        assert last["pricing"] == "floors" and "not a prediction" in out


@pytest.mark.parametrize("mod", [RL, SM])
def test_no_card_raises_and_no_jax_in_the_port(mod):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--splats", "100"])
    src = inspect.getsource(mod)
    assert not re.search(r"^\s*(import jax|from jax|import bench|from tools|.*splatapult_tpu\.)",
                         src, re.M)
    assert not [r for r in JAX_TPU_RATES if re.search(rf"(?<![\d.]){re.escape(r)}(?![\d])", src)]
