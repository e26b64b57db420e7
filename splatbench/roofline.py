"""Peaks of the card and the least time any correct implementation needs.

The counts come from the reference's own walk of the cell's inputs
(reference/render.work_counts), never from the program's buffers, so the
yardstick stays the same whatever implements a kernel. A floor counts only
work that the result needs: the scene read once, the image written once (and
in training the target read once, the gradients and the parameters written
once and Adam's two moments read and written once), the composite's
arithmetic on the (instance, pixel) pairs above the discard up to where the
walk stops. The floor is the larger of the bytes at the memory rate and the
operations at the float32 rate.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet (700 W): HBM3 bandwidth, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

PARAM_FLOATS = 59  # means 3, SH 48, opacity 1, log-scales 3, quaternion 4 (SH degree 3)
PIXEL_BYTES = 16  # an RGBA float32 pixel
FEATURE_BYTES = 36  # what the composite reads of a splat: mean 2, conic 3, alpha 1, RGB 3
INDEX_BYTES = 4  # one (splat, tile) instance named by a 32-bit index
# multiply-adds per pair above the discard: the forward's exponent 6, exp 4,
# weight 1, colour 3, transmittance 1; the backward's replay of the forward
# 15 and 25 more (colour dot 3, effective weight and suffix 2, the weight's
# derivative 6, exponent and transmittance 2, nine products, pixel sums 3)
FWD_PAIR_FLOP = 2 * 15
BWD_PAIR_FLOP = 2 * 40
# Adam's passes over the parameters beyond the read: the gradient and the
# parameters written, the two moments read and written
STEP_PASSES = 1 + 1 + 1 + 4


def floor_s(nbytes: float, flop: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flop / FP32_FLOP_PER_S)


def composite_fwd_floor_s(w: dict) -> float:
    """The composite forward (B2): the instances' indices and the covered
    splats' features read, the image written, the forward's pair arithmetic."""
    nbytes = INDEX_BYTES * w["instances"] + FEATURE_BYTES * w["splats"] + PIXEL_BYTES * w["pixels"]
    return floor_s(nbytes, FWD_PAIR_FLOP * w["pairs"])


def composite_bwd_floor_s(w: dict) -> float:
    """The composite backward (B3): indices and features read, the image's
    cotangent read, a gradient per covered splat's features written, the
    backward's pair arithmetic."""
    nbytes = (INDEX_BYTES * w["instances"] + 2 * FEATURE_BYTES * w["splats"]
              + PIXEL_BYTES * w["pixels"])
    return floor_s(nbytes, BWD_PAIR_FLOP * w["pairs"])


def frame_floor_s(w: dict) -> float:
    nbytes = 4 * PARAM_FLOATS * w["scene_splats"] + PIXEL_BYTES * w["pixels"]
    return floor_s(nbytes, FWD_PAIR_FLOP * w["pairs"])


def step_floor_s(w: dict) -> float:
    nbytes = (4 * PARAM_FLOATS * STEP_PASSES * w["scene_splats"]
              + 2 * PIXEL_BYTES * w["pixels"])
    return floor_s(nbytes, (FWD_PAIR_FLOP + BWD_PAIR_FLOP) * w["pairs"])
