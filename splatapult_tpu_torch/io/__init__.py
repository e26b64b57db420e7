from splatapult_tpu_torch.io.ply import PlyData, read_ply, write_ply
from splatapult_tpu_torch.io.gaussians import (
    GaussianScene,
    load_gaussian_ply,
    save_gaussian_ply,
    make_debug_scene,
    prune_splats,
    scene_from_ply,
)
from splatapult_tpu_torch.io.points import (
    PointScene,
    load_point_ply,
    save_point_ply,
    make_debug_points,
)
from splatapult_tpu_torch.io.configs import (
    CameraInfo,
    load_cameras_json,
    load_vr_config,
    save_vr_config,
    find_config_file,
    estimate_floor_plane,
)

__all__ = [
    "PlyData",
    "read_ply",
    "write_ply",
    "GaussianScene",
    "scene_from_ply",
    "load_gaussian_ply",
    "save_gaussian_ply",
    "make_debug_scene",
    "prune_splats",
    "PointScene",
    "load_point_ply",
    "save_point_ply",
    "make_debug_points",
    "CameraInfo",
    "load_cameras_json",
    "load_vr_config",
    "save_vr_config",
    "find_config_file",
    "estimate_floor_plane",
]
