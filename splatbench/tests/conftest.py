"""The benchmark's own tests: CPU tests at tiny sizes, and tests marked
``card`` that need an NVIDIA GPU and skip without one (decided inside the
``card`` fixture, never while a module is imported)."""

from __future__ import annotations

import json
import os
import shutil

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY = {"num_splats": 6000, "width": 96, "height": 64}
# the program's own runs: a change's norm by leaf gathers enough splats at this count
# for the bf16 tail's noise to sit under the limits set at the cells' sizes
# (production step_gap 3.7e-5 at 6,000 splats, 2.5e-5 at 30,000, 4.7e-6 at most at 1.5M)
SMALL = {"num_splats": 60000, "width": 96, "height": 64}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


def make_tiny_tree(root: str, sizes: dict = TINY) -> str:
    """A copy of BENCHMARK.json and splatbench/ under ``root`` with every
    configuration cut to ``sizes`` (6,000 splats at 96 x 64) and the mixes to
    8 views (so that the CPU's plain versions finish in seconds) -> its
    splatbench/."""
    here = os.path.join(root, "splatbench")
    shutil.copytree(os.path.join(REPO, "splatbench"), here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for entry in bench["configs"]:
        path = os.path.join(root, entry["file"])
        with open(path) as f:
            cfg = json.load(f)
        cfg.update(sizes)
        with open(path, "w") as f:
            json.dump(cfg, f)
    for name in os.listdir(os.path.join(here, "traffic")):
        path = os.path.join(here, "traffic", name)
        with open(path) as f:
            tr = json.load(f)
        tr.update(views=8, warmup_frames=1, trace_frames=3, trace_stride=3, timing_seconds=0.05,
                  warmup_steps=1, readback_every=4, trace_steps=2)
        with open(path, "w") as f:
            json.dump(tr, f)
    return here


@pytest.fixture(scope="session")
def tiny_tree(tmp_path_factory):
    torch.set_num_threads(4)
    root = str(tmp_path_factory.mktemp("bench"))
    return root, make_tiny_tree(root)


@pytest.fixture(scope="session")
def small_tree(tmp_path_factory):
    torch.set_num_threads(4)
    root = str(tmp_path_factory.mktemp("bench_small"))
    return root, make_tiny_tree(root, SMALL)

