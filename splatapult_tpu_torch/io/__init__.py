from splatapult_tpu_torch.io.gaussians import (
    GaussianScene,
    load_gaussian_ply,
    make_debug_scene,
    save_gaussian_ply,
    scene_from_ply,
)
from splatapult_tpu_torch.io.ply import PlyData, read_ply, write_ply

__all__ = [
    "PlyData",
    "read_ply",
    "write_ply",
    "GaussianScene",
    "scene_from_ply",
    "load_gaussian_ply",
    "save_gaussian_ply",
    "make_debug_scene",
]
