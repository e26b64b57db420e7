"""The port's tools/profile_overlap.py counterpart on the CPU: two gloo ranks
at a tiny size, run as a user runs it (``python -m``) under its own timeout.

It is a timing tool with no JAX counterpart to compare against (the JAX tool
times XLA programs); what is held here is its mechanism: the ranks finish,
A, B, C, the overlap and the SH all-reduce's issue-to-backward-end time are
finite, one SH all-reduce a step is issued inside the backward as a
collective, and the last line is the JSON summary, marked a mechanism
check."""

import json
import math
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL_TIMEOUT_S = 120  # the tool kills its ranks at --timeout 90 s, before this
KEYS = ("full_step_ms", "no_collective_ms", "collectives_ms", "exposed_ms", "overlap",
        "sh_allreduce_issue_to_backward_end_ms")


def test_profile_overlap_two_cpu_ranks():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "splatapult_tpu_torch.tools.profile_overlap", "--world", "2",
         "--device", "cpu", "--backend", "gloo", "--splats", "2000", "--width", "64",
         "--height", "32", "--iters", "2", "--timeout", "90"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=TOOL_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    out = json.loads(lines[-1])
    assert out["world"] == 2 and out["device"] == "cpu" and out["backend"] == "gloo"
    assert "mechanism check only" in out["note"]
    assert sum(ln.startswith("rank ") for ln in lines[:-1]) == 2
    assert len(out["ranks"]) == 2
    for r in out["ranks"]:
        for k in KEYS:
            assert math.isfinite(r[k]), (k, r[k])
        assert r["full_step_ms"] > 0 and r["collectives_ms"] > 0
        assert r["sh_allreduce_issue_to_backward_end_ms"] >= 0
        assert r["sh_allreduces_per_step"] == [1] * 2
        assert r["sh_collectives_per_step"] == [1] * 2
        assert r["window_clock"] == "host clock"
        assert r["sh_bytes"] == 2000 * 3 * 16 * 4  # the garden stand-in is SH degree 3
    for k in KEYS:
        assert math.isfinite(out[k]), k


def test_profile_overlap_ring_raises():
    """--allreduce ring (a ring of ppermutes) is not ported (ROADMAP queue 1
    item 16); the tool refuses it before spawning a rank."""
    from splatapult_tpu_torch.tools import profile_overlap

    with pytest.raises(NotImplementedError, match="item 16"):
        profile_overlap.main(["--allreduce", "ring", "--device", "cpu"])
