"""Scene config files: cameras.json, <ply>_vr.json, and scene-dir discovery.

Capability parity with the reference's config layer:
- cameras.json parsing with the same axis swizzle to -Z forward / +Y up
  (ref: CamerasConfig::ImportJson, src/camerasconfig.cpp:20-67)
- floor-plane estimation from camera poses
  (ref: CamerasConfig::EstimateFloorPlane, src/camerasconfig.cpp:69-95)
- <ply>_vr.json floorMat round-trip (ref: src/vrconfig.cpp:20-65)
- config discovery walking the ply's directory and two parents
  (ref: App::FindConfigFile, src/app.cpp:89-119)

Host-side numpy only; render.Camera.from_fov places a CameraInfo's matrix on
a device.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class CameraInfo:
    """One trainer camera: cam-to-world matrix (-Z forward, +Y up) + intrinsics."""

    id: int
    cam_to_world: np.ndarray  # [4, 4] float32
    fov: np.ndarray  # (fovx, fovy) radians
    width: int
    height: int
    fx: float
    fy: float

    @property
    def position(self) -> np.ndarray:
        return self.cam_to_world[:3, 3]


def load_cameras_json(path: str) -> List[CameraInfo]:
    """Parse the INRIA trainer's cameras.json.

    Entries carry {id, position, rotation (3x3 row-major world-from-camera
    columns), width, height, fx, fy}. The rotation columns are negated for
    Y and Z to swizzle into GL's -Z forward / +Y up convention, and
    fov = 2*atan(dim / (2*fx)) — including the reference's quirk of using fx
    for the vertical fov too (ref: src/camerasconfig.cpp:47-56).
    """
    with open(path) as f:
        data = json.load(f)
    cameras = []
    for o in data:
        pos = np.asarray(o["position"], np.float32)
        # The reference's glm constructor consumes jRot column-major such that
        # the JSON nested list acts as a row-major matrix whose *columns* feed
        # the camera axes (ref: src/camerasconfig.cpp:38-41, 50-55).
        rot = np.asarray(o["rotation"], np.float32)
        mat = np.eye(4, dtype=np.float32)
        mat[:3, 0] = rot[:, 0]
        mat[:3, 1] = -rot[:, 1]
        mat[:3, 2] = -rot[:, 2]
        mat[:3, 3] = pos
        fx, fy = float(o["fx"]), float(o["fy"])
        width, height = int(o["width"]), int(o["height"])
        fov = np.asarray(
            [2.0 * np.arctan(width / (2.0 * fx)), 2.0 * np.arctan(height / (2.0 * fx))],
            np.float32,
        )
        cameras.append(
            CameraInfo(
                id=int(o["id"]), cam_to_world=mat, fov=fov,
                width=width, height=height, fx=fx, fy=fy,
            )
        )
    return cameras


def estimate_floor_plane(cameras: List[CameraInfo]):
    """(normal, point) of the scene floor: mean camera up + mean height along it
    (ref: CamerasConfig::EstimateFloorPlane, src/camerasconfig.cpp:69-95)."""
    if not cameras:
        return np.asarray([0.0, 1.0, 0.0], np.float32), np.zeros(3, np.float32)
    ups = np.stack([c.cam_to_world[:3, 1] for c in cameras])
    avg_up = ups.mean(axis=0)
    norm = np.linalg.norm(avg_up)
    avg_up = avg_up / norm if norm > 1e-12 else np.asarray([0.0, 1.0, 0.0], np.float32)
    positions = np.stack([c.position for c in cameras])
    avg_dist = float(np.mean(positions @ avg_up))
    return avg_up.astype(np.float32), (avg_up * avg_dist).astype(np.float32)


def load_vr_config(path: str) -> np.ndarray:
    """Read the 4x4 floorMat from a <ply>_vr.json (ref: src/vrconfig.cpp:20-46).

    The reference feeds jmat[c][r] pairs into GLM's column-major constructor
    (ref: src/vrconfig.cpp:31-35), which exactly cancels: the JSON nested list
    is the row-major matrix (its last sublist is [0, 0, 0, 1]).
    """
    with open(path) as f:
        obj = json.load(f)
    return np.asarray(obj["floorMat"], np.float32)


def save_vr_config(path: str, floor_mat) -> None:
    """Write a <ply>_vr.json (ref: VrConfig::ExportJson, src/vrconfig.cpp:48-65)."""
    m = np.asarray(floor_mat, np.float32)
    obj = {"floorMat": [[float(v) for v in row] for row in m]}
    with open(path, "w") as f:
        json.dump(obj, f, indent=4)


def find_config_file(filename: str, start_dir: str, levels: int = 3) -> Optional[str]:
    """Search start_dir and up to ``levels - 1`` parents for filename
    (ref: App::FindConfigFile, src/app.cpp:89-119, which checks the ply dir
    plus two parents)."""
    d = os.path.abspath(start_dir)
    for _ in range(levels):
        candidate = os.path.join(d, filename)
        if os.path.isfile(candidate):
            return candidate
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    return None


def discover_scene(ply_path: str) -> dict:
    """Asset discovery around a .ply, the way App::Init walks the scene dir
    (ref: src/app.cpp:418-533): cameras.json, <stem>_vr.json, and input.ply."""
    ply_dir = os.path.dirname(os.path.abspath(ply_path))
    stem = os.path.splitext(os.path.basename(ply_path))[0]
    return {
        "ply": ply_path,
        "cameras_json": find_config_file("cameras.json", ply_dir),
        "vr_json": find_config_file(stem + "_vr.json", ply_dir),
        "input_ply": find_config_file("input.ply", ply_dir),
    }
