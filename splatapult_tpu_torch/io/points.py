"""SfM point-cloud container (the trainer's ``input.ply``).

Capability parity with the reference's PointCloud (ref: src/pointcloud.cpp):
positions (float or double) + uchar RGB colors, optional sRGB -> linear
conversion (ref: src/pointcloud.cpp:76-95 — note the reference converts the
*positions*, reproducing a quirk of its implementation is not useful, so we
convert the colors, which is what the flag is for), a procedural debug cloud,
and an exporter (which the reference stubs out, ref: src/pointcloud.cpp:133-141).

Rendering SfM points is a trivial special case of splat rendering: each point
becomes an isotropic fixed-size splat (see points_as_gaussians), replacing the
reference's textured-billboard point pipeline (ref: src/pointrenderer.cpp,
shader/point_vert/geom/frag.glsl). The point cloud itself is host-side numpy;
points_as_gaussians puts the splats on a device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from splatapult_tpu_torch._device import DEFAULT_DEVICE, resolve_device
from splatapult_tpu_torch.io.ply import PlyData, make_ply, read_ply, write_ply


@dataclasses.dataclass
class PointScene:
    positions: np.ndarray  # [N, 3] float32
    colors: np.ndarray  # [N, 3] float32 in [0, 1]

    @property
    def num_points(self) -> int:
        return int(self.positions.shape[0])


def _srgb_to_linear_np(c):
    return np.where(c <= 0.04045, c / 12.92, np.power((c + 0.055) / 1.055, 2.4))


def points_from_ply(ply: PlyData, use_linear_colors: bool = False) -> PointScene:
    positions = ply.columns(["x", "y", "z"], dtype=np.float32)
    colors = ply.columns(["red", "green", "blue"], dtype=np.float32) / 255.0
    if use_linear_colors:
        colors = _srgb_to_linear_np(colors).astype(np.float32)
    return PointScene(positions=positions, colors=colors)


def load_point_ply(path: str, use_linear_colors: bool = False) -> PointScene:
    return points_from_ply(read_ply(path), use_linear_colors=use_linear_colors)


def save_point_ply(path: str, scene: PointScene) -> None:
    positions = np.asarray(scene.positions, np.float32)
    colors = np.clip(np.asarray(scene.colors, np.float32) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    ply = make_ply(
        {
            "x": positions[:, 0],
            "y": positions[:, 1],
            "z": positions[:, 2],
            "red": colors[:, 0],
            "green": colors[:, 1],
            "blue": colors[:, 2],
        }
    )
    write_ply(path, ply)


def make_debug_points() -> PointScene:
    """RGB-axes debug point cloud, 15 points
    (ref: PointCloud::InitDebugCloud, src/pointcloud.cpp:199-253)."""
    num = 5
    delta = 1.0 / num
    positions, colors = [], []
    for axis in range(3):
        for i in range(num):
            p = [0.0, 0.0, 0.0]
            p[axis] = i * delta
            positions.append(p)
            c = [0.0, 0.0, 0.0]
            c[axis] = 1.0
            colors.append(c)
    return PointScene(
        positions=np.asarray(positions, np.float32), colors=np.asarray(colors, np.float32)
    )


def points_as_gaussians(scene: PointScene, world_radius: float = 0.01,
                        device=DEFAULT_DEVICE):
    """Lift points to an equivalent GaussianScene of small isotropic opaque
    splats on ``device``, so the splat pipeline renders them (the reference
    draws NDC-sized billboards, pointSize=0.02, ref: src/pointrenderer.cpp:182)."""
    from splatapult_tpu_torch.io.gaussians import SH_C0, _scene_from_arrays

    n = scene.num_points
    colors = np.asarray(scene.colors, np.float32)
    sh0 = (colors - 0.5) / SH_C0  # invert color = 0.5 + SH_C0 * dc
    return _scene_from_arrays(
        means=np.asarray(scene.positions, np.float32),
        sh=sh0[:, :, None],
        opacities=np.full((n,), 12.0, np.float32),
        log_scales=np.full((n, 3), np.log(world_radius), np.float32),
        quats=np.tile(np.asarray([1.0, 0.0, 0.0, 0.0], np.float32), (n, 1)),
        device=resolve_device(device),
    )
