"""What decides ``correct``, shown to fail: the control (the program with its
own bf16 accumulation switched on) and each fault a cell can have, planted
underneath a whole run with the look for a card skipped, at a size the CPU
holds. On the card, ``test_control_fails_at_the_cells_size`` runs the control
at the cells' own sizes on three seeds."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from splatbench import faults, run
from splatbench.calibrate import CONTROL

from .conftest import REPO

BENCH = run.benchmark(REPO)
KINDS = {c["name"]: run.traffic_of(c)["kind"] for c in BENCH["workloads"]}
VIEW_CELLS = [c for c, k in KINDS.items() if k == "view"]
TRAIN_CELLS = [c for c, k in KINDS.items() if k == "train"]
CASES = ([(c, "control") for c in VIEW_CELLS + TRAIN_CELLS]
         + [(c, f) for c in VIEW_CELLS for f in ("altered", "half_batch")]
         + [(c, f) for c in TRAIN_CELLS for f in faults.FAULTS])


@pytest.mark.parametrize("cell", VIEW_CELLS + TRAIN_CELLS)
def test_the_program_passes(small_tree, cell):
    root, here = small_tree
    # a view's window holds enough frames (at about 0.5 s a frame here) for its p95
    seconds = 3.0 if cell in VIEW_CELLS else 1.0
    line = run.run_cell(cell, 987654321098, seconds, False, torch.device("cpu"), root=root,
                        here=here)
    assert line["correct"] is True, line["checks"]


@pytest.mark.parametrize("cell,fault", CASES)
def test_the_control_and_faults_fail(tiny_tree, cell, fault):
    root, here = tiny_tree
    with faults.planted(None if fault == "control" else fault):
        line = run.run_cell(cell, 987654321098, 1.0, False, torch.device("cpu"), root=root,
                            here=here, overrides=CONTROL if fault == "control" else None)
    assert line["correct"] is False, line["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", VIEW_CELLS + TRAIN_CELLS)
def test_control_fails_at_the_cells_size(card, cell):
    done = subprocess.run([sys.executable, "-m", "splatbench.calibrate", "--workload", cell,
                           "--seeds", "0", "--control-seeds", "3", "--seconds", "1"],
                          cwd=REPO, capture_output=True, text=True, timeout=1800)
    assert done.returncode == 0, done.stderr[-4000:]
    limits = run.limits_of(run.cell_of(BENCH, cell))
    for line in done.stdout.splitlines()[:-1]:
        checks = json.loads(line)["checks"]
        assert any(checks[k] > limits[k] for k in checks), checks
