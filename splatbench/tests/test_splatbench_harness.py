"""The harness: BENCHMARK.json against the contract it is written to, the
lookup of every piece by name, the result line's shape, a cell added from
files alone, and the check that no module of JAX or the JAX package loads."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from splatbench import run

from .conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = run.benchmark(REPO)
CELLS = [c["name"] for c in BENCH["workloads"]]


def test_benchmark_json_keeps_to_the_contract():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["splatbench"] and 1 <= b["run_seconds"] <= 51
    assert all(isinstance(w, str) and not w.startswith("/") and ".." not in w
               for w in b["command"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("splatbench/") and os.path.exists(os.path.join(REPO, c["file"]))
        assert any(w["config"] == c["name"] for w in b["workloads"])
    pairs = {(w["config"], w["traffic"]) for w in b["workloads"]}
    assert len(pairs) == len(b["workloads"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_every_piece_of_a_cell_is_found_by_name(cell):
    c = run.cell_of(BENCH, cell)
    config = run.config_of(BENCH, c, REPO)
    traffic = run.traffic_of(c)
    assert run.driver_of(traffic["kind"]).run
    e2e = run.metric_entries(BENCH, cell, False)
    layers = run.metric_entries(BENCH, cell, True)
    names = [m["name"] for m in e2e]
    assert "setup_s" in names and len(names) >= 2 and layers
    for m in e2e + layers:
        assert callable(run.reader(m["name"]))
    for m in layers:
        assert m["moves"] in names
    assert config["width"] == 1920 and config["height"] == 1080 and config["sh_degree"] == 3
    assert set(run.limits_of(c)) == ({"img_err_mean", "img_err_p999"} if traffic["kind"] == "view"
                                     else {"loss_gap", "grad_gap", "step_gap"})


def test_result_line_has_the_keys_the_driver_reads(tiny_tree):
    root, here = tiny_tree
    line = run.run_cell("garden-5m.view", 2 ** 31 + 12345, 1.0, False,
                        torch.device("cpu"), root=root, here=here)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"frame_ms", "frame_ms_p95", "peak_mem_gib", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())
    json.dumps(line)


def test_a_cell_a_mix_and_a_metric_are_added_as_files(tmp_path):
    from .conftest import make_tiny_tree

    root = str(tmp_path)
    here = make_tiny_tree(root)
    with open(os.path.join(here, "traffic", "view.json")) as f:
        mix = json.load(f)
    mix.update(radius_min=2.5, radius_max=3.0)
    with open(os.path.join(here, "traffic", "view-near.json"), "w") as f:
        json.dump(mix, f)
    shutil.copy(os.path.join(here, "configs", "garden-5m.json"),
                os.path.join(here, "configs", "garden-5m-copy.json"))
    with open(os.path.join(here, "metrics", "frames_done.py"), "w") as f:
        f.write("def read(out, ctx):\n    return out['window']['frames']\n")
    shutil.copy(os.path.join(here, "limits", "garden-5m.view.json"),
                os.path.join(here, "limits", "garden-5m-copy.view-near.json"))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "garden-5m-copy", "source": "https://example.org",
                             "file": "splatbench/configs/garden-5m-copy.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "garden-5m-copy.view-near", "config": "garden-5m-copy",
                               "traffic": "view-near", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "frames_done", "unit": "frames", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["garden-5m-copy.view-near"]})
    for m in bench["end_to_end"]:
        if m["name"] == "frame_ms":
            m["workloads"].append("garden-5m-copy.view-near")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    line = run.run_cell("garden-5m-copy.view-near", 7, 0.5, False, torch.device("cpu"),
                        root=root, here=here)
    assert line["metrics"]["frames_done"]["value"] == line["attempted"] > 0
    assert set(line["metrics"]) == {"frame_ms", "frames_done", "peak_mem_gib", "setup_s"}


def test_main_without_a_card_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "garden-5m.view", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copytree(os.path.join(REPO, "splatbench"), tmp_path / "splatbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    done = subprocess.run([sys.executable, *BENCH["command"][1:], "--workload", "garden-5m.view",
                           "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode != 0 and done.stdout == ""


def test_forbidden_modules_are_matched_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "splatapult_tpu_torch_lookalike", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "splatapult_tpu", sys)
    assert run.forbidden_modules() == ["jax.numpy", "splatapult_tpu"]


def test_a_run_loads_no_jax_and_the_reference_nothing_of_the_program():
    code = ("import sys, importlib, torch; "
            "import splatbench.reference.render; "
            "assert not [m for m in sys.modules if m.split('.')[0] == 'splatapult_tpu_torch']; "
            "from splatbench import run; "
            "[importlib.import_module('splatbench.drivers.' + k) for k in ('view', 'train')]; "
            "importlib.import_module('splatapult_tpu_torch.train'); "
            "importlib.import_module('splatapult_tpu_torch.ops.tiled'); "
            "print(run.forbidden_modules())")
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip() == "[]"
    src = open(os.path.join(REPO, "splatbench", "reference", "render.py")).read()
    assert "splatapult" not in src and "jax" not in src
