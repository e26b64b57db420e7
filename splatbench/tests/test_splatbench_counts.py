"""The work counts behind the rooflines against hand-counted cases, the floors
against hand arithmetic, and the trace reader on a trace written by hand."""

from __future__ import annotations

import math

import pytest
import torch

from splatbench import roofline, traffic
from splatbench.reference import render as ref
from splatbench.trace import Trace

W, H = 96, 64
FOVY = math.pi / 4


def one_place(n, sigma, opacity):
    """n identical isotropic splats at the origin, seen from (0, 0, 3)."""
    return {"means": torch.zeros(n, 3), "sh": torch.zeros(n, 3, 16),
            "opacities": torch.full((n,), opacity), "log_scales": torch.full((n, 3), math.log(sigma)),
            "quats": torch.tensor([[1.0, 0.0, 0.0, 0.0]]).repeat(n, 1)}


def camera():
    return (traffic.look_at([0.0, 0.0, 3.0], [0.0, 0.0, 0.0]),
            traffic.perspective(FOVY, W / H, 0.1, 1000.0))


@pytest.mark.parametrize("sigma", [0.002, 0.01, 0.03])
def test_pairs_of_one_splat_are_the_pixels_of_its_disc(sigma):
    alpha = 0.9
    params = one_place(1, sigma, math.log(alpha / (1 - alpha)))
    cfg = ref.RefConfig(width=W, height=H)
    w = ref.work_counts(params, *camera(), cfg)
    # by hand: focal length H / (2 tan(fovy / 2)) px, 2D variance (f sigma / 3)^2 + 0.3 about the
    # image centre; a pixel counts where alpha exp(-r^2 / 2 var) > 1/256
    f = H / (2 * math.tan(FOVY / 2))
    var = (f * sigma / 3.0) ** 2 + 0.3
    r2_max = 2 * var * math.log(alpha * 256)
    hand = sum(1 for x in range(W) for y in range(H)
               if (x + 0.5 - W / 2) ** 2 + (y + 0.5 - H / 2) ** 2 < r2_max)
    assert w["pairs"] == hand and w["splats"] == 1 and w["scene_splats"] == 1
    assert w["pixels"] == W * H


def test_the_early_stop_ends_each_tile_after_its_first_block():
    params = one_place(300, 3.0, math.log(0.99 / 0.01))
    exact = ref.work_counts(params, *camera(), ref.RefConfig(width=W, height=H))
    stops = ref.work_counts(params, *camera(), ref.RefConfig(width=W, height=H,
                                                              early_stop_eps=1e-4))
    tiles = 3 * 2
    assert exact["instances"] == 300 * tiles and exact["pairs"] == 300 * tiles * 1024
    assert stops["instances"] == 128 * tiles and stops["pairs"] == 128 * tiles * 1024


def test_floors_by_hand():
    w = {"pairs": 10 ** 9, "instances": 10 ** 7, "splats": 4 * 10 ** 6, "pixels": 2 * 10 ** 6,
         "scene_splats": 5 * 10 ** 6}
    assert roofline.frame_floor_s(w) == max((5e6 * 236 + 32e6) / 3.35e12, 30e9 / 67e12)
    assert roofline.step_floor_s(w) == max((5e6 * 236 * 7 + 64e6) / 3.35e12, 110e9 / 67e12)
    assert roofline.composite_fwd_floor_s(w) == 30e9 / 67e12
    assert roofline.composite_bwd_floor_s(w) == 80e9 / 67e12
    assert roofline.composite_fwd_floor_s(dict(w, pairs=1)) == (4e7 + 144e6 + 32e6) / 3.35e12


def test_trace_reader():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "prepare", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 5, "dur": 10, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 8, "dur": 2,
         "tid": 1, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::sort", "ts": 150, "dur": 20, "tid": 2},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 160, "dur": 2,
         "tid": 2, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "mul_kernel", "ts": 20, "dur": 30,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "composite_bwd_kernel<1>", "ts": 200, "dur": 50,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 240, "dur": 20,
         "args": {"correlation": 2}},
    ]
    t = Trace(ev)
    assert t.busy_s() == pytest.approx((30 + 60) * 1e-6)
    assert t.span_busy_s("prepare") == pytest.approx(30e-6)
    assert t.span_busy_s("backward") == 0.0
    assert t.kernel_s("composite_bwd_kernel") == pytest.approx(50e-6)
    b = t.breakdown()
    assert b["device_ops"][0] == ["composite_bwd_kernel<1>", pytest.approx(50e-6)]
    assert b["idle_gaps"] == [["aten::sort", pytest.approx(150e-6)]]
