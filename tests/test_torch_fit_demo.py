"""PyTorch port vs. the JAX package: training at length through the port's
fit demo (splatapult_tpu_torch/tools/fit_demo.py) against the JAX repo's
tools/fit_demo.py, both at --tiny (2,000 splats, 2 views, 256x144, 8 steps,
the production profile), on the CPU.

Both tools draw the same perturbation from one numpy Generator, so they start
from the same scene, and fit it in two phases around a checkpoint with a
fresh optimizer each. The losses agree within rtol 1e-3, the production
profile's tolerance for fit_scene (20-bit depth key, packed colours, the
early stop and the bf16 gradient tail round differently in the two
packages). The adaptive run (--adaptive) has no JAX counterpart here: the
port carries the Adam state through each event and calibrates the capacity
again (ROADMAP queue 3), so it is held to its own contract.
"""

import concurrent.futures
import json
import math
import os
import sys

import pytest
import torch

from splatapult_tpu_torch.tools import fit_demo
from splatapult_tpu_torch.utils.image import load_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PNGS = ("before.png", "target.png", "after.png")
# torch threads for the port's two runs, while the JAX tool runs in a thread
# of its own beside them (the module's whole cost is these three runs; on
# one thread the file takes about 42 s, on four about 24 s)
PORT_THREADS = 4


def _jax_fit_demo(out):
    sys.path.insert(0, REPO)
    from tools.fit_demo import main

    return main(["--tiny", "--out", out])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX tool's --tiny run (in a thread) beside the port's --tiny run
    and its --tiny --adaptive run with an event after step 4 -> {name:
    (summary, loss_curve.json, out dir)}."""
    outs = {k: str(tmp_path_factory.mktemp(k)) for k in ("jax", "port", "adaptive")}
    threads = torch.get_num_threads()
    torch.set_num_threads(PORT_THREADS)
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            jax_run = pool.submit(_jax_fit_demo, outs["jax"])
            summaries = {
                "port": fit_demo.main(["--tiny", "--device", "cpu", "--out", outs["port"]]),
                "adaptive": fit_demo.main(["--tiny", "--device", "cpu", "--adaptive",
                                           "--out", outs["adaptive"]]),
            }
            summaries["jax"] = jax_run.result(timeout=300)
    finally:
        torch.set_num_threads(threads)
    out = {}
    for k, d in outs.items():
        with open(os.path.join(d, "loss_curve.json")) as f:
            out[k] = (summaries[k], json.load(f), d)
    return out


def test_losses_match_the_jax_tool(runs):
    want, got = runs["jax"][1]["losses"], runs["port"][1]["losses"]
    assert len(got) == len(want) == 8
    assert got == pytest.approx(want, rel=1e-3)
    assert got[-1] < got[0] * 0.9


def test_summary_has_the_jax_keys_and_the_checkpoint_round_trip(runs):
    jax_summary, port_summary = runs["jax"][0], runs["port"][0]
    assert set(jax_summary) <= set(port_summary), sorted(set(jax_summary) - set(port_summary))
    assert port_summary["checkpoint_roundtrip"] == "exact"
    assert port_summary["device"] == port_summary["nvidia_smi_name_power_limit"] == "cpu"
    assert port_summary["num_culled_instances"] == [0, 0, 0]
    assert runs["port"][1]["summary"] == port_summary
    for k in ("splats", "views", "resolution", "steps", "lr", "profile"):
        assert port_summary[k] == jax_summary[k], k
    assert not os.path.exists(os.path.join(runs["port"][2], "ckpt_mid.npz"))


def test_pngs_have_the_jax_tool_sizes(runs):
    for name in PNGS:
        want = load_png(os.path.join(runs["jax"][2], name)).shape
        assert want[:2] == (144 // 4, 256 // 4)
        for k in ("port", "adaptive"):
            assert load_png(os.path.join(runs[k][2], name)).shape == want, (k, name)


def test_adaptive_run_grows_the_scene_and_drops_no_instance(runs):
    summary, record, _ = runs["adaptive"]
    losses, events = record["losses"], record["events"]
    assert len(losses) == 8 and all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0]
    assert [e["step"] for e in events] == [4]
    (e,) = events
    assert e["cloned"] + e["split"] > 0 and e["num_splats"] > summary["splats"]
    assert summary["splats_final"] == e["num_splats"]
    assert e["emax"] % 4096 == 0 and e["event_ms"] > 0.0
    # at the start of both chunks and at the end
    assert summary["num_culled_instances"] == [0, 0, 0]
    assert 0.0 < summary["event_share_of_wall"] < 1.0
    assert summary["checkpoint_roundtrip"] is None and summary["adaptive"] is True
    # no second phase: the JAX tool's per-step key stays empty
    assert summary["step_ms_incl_compile_phase2"] is None
    assert summary["wall_ms_per_step"] == pytest.approx(summary["wall_s"] * 1e3 / 8)


def test_without_a_card_it_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal cannot show")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit_demo.main(["--tiny", "--out", str(tmp_path)])
