"""The one generator that every traffic mix's parameters feed: camera paths and
rings, training targets and the order of training views.

A mix is a JSON file under ``traffic/``; its ``kind`` names the driver under
``drivers/`` that runs it. Cameras are GL-style camera-to-world matrices
(-Z forward, +Y up) and GL projections, as float32 numpy [4, 4] arrays.
"""

from __future__ import annotations

import math
import random

import numpy as np
import torch


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, np.cross(right, fwd), -fwd, eye
    return m.astype(np.float32)


def perspective(fovy: float, aspect: float, near: float, far: float) -> np.ndarray:
    f = 1.0 / math.tan(fovy / 2.0)
    m = np.zeros((4, 4), np.float64)
    m[0, 0], m[1, 1] = f / aspect, f
    m[2, 2], m[2, 3] = -(far + near) / (far - near), -2.0 * far * near / (far - near)
    m[3, 2] = -1.0
    return m.astype(np.float32)


def _projection(traffic: dict, config: dict) -> np.ndarray:
    return perspective(traffic["fovy"], config["width"] / config["height"],
                       traffic["near"], traffic["far"])


def orbit_path(traffic: dict, config: dict) -> list:
    """``views`` cameras once round the orbit at ``height``, looking at
    ``target``, the radius moving as a sinusoid between ``radius_min`` and
    ``radius_max`` with ``radius_periods`` periods a round -> [(c2w, proj)]."""
    proj = _projection(traffic, config)
    v, lo, hi = traffic["views"], traffic["radius_min"], traffic["radius_max"]
    out = []
    for k in range(v):
        a = 2 * math.pi * k / v
        r = 0.5 * (lo + hi) + 0.5 * (hi - lo) * math.cos(2 * math.pi * traffic["radius_periods"] * k / v)
        out.append((look_at([r * math.cos(a), traffic["height"], r * math.sin(a)],
                            traffic["target"]), proj))
    return out


def ring(traffic: dict, config: dict) -> list:
    """``views`` capture cameras evenly on a ring of ``radius`` -> [(c2w, proj)]."""
    proj = _projection(traffic, config)
    v, r = traffic["views"], traffic["radius"]
    return [(look_at([r * math.cos(2 * math.pi * k / v), traffic["height"],
                      r * math.sin(2 * math.pi * k / v)], traffic["target"]), proj)
            for k in range(v)]


CAMERAS = {"orbit_path": orbit_path, "ring": ring}


def cameras(traffic: dict, config: dict) -> list:
    return CAMERAS[traffic["cameras"]](traffic, config)


def targets(traffic: dict, config: dict, seed: int, device) -> torch.Tensor:
    """One smooth seeded image a view -> [V, H, W, 4] float32 (premultiplied
    RGBA, alpha 1): a ``target_grid`` of uniform colours in [0.1, 0.9],
    bilinearly upsampled."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) ^ 0x7A46E7) % (1 << 63))
    gh, gw = traffic["target_grid"]
    coarse = torch.rand((traffic["views"], 3, gh, gw), generator=g, device=device) * 0.8 + 0.1
    rgb = torch.nn.functional.interpolate(coarse, size=(config["height"], config["width"]),
                                          mode="bilinear", align_corners=False)
    ones = torch.ones_like(rgb[:, :1])
    return torch.cat([rgb, ones], 1).permute(0, 2, 3, 1).contiguous()


def epoch_order(seed: int, views: int):
    """View indices, every epoch a fresh seeded shuffle of all views."""
    rng = random.Random(int(seed))
    while True:
        order = list(range(views))
        rng.shuffle(order)
        yield from order
