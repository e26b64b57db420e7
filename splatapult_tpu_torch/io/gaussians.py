"""Gaussian splat scene container: PLY <-> SoA parameter tensors.

Capability parity with the reference's GaussianCloud (ref: src/gaussiancloud.cpp).
Key difference by design: the reference pre-bakes {cov3x3, alpha} on import
(ref: src/gaussiancloud.cpp:254-362) because it is forward-only; we keep the
*trainer parameterization* {quat, log-scale, logit-opacity, SH} as the canonical
scene state and bake covariance/alpha inside the forward pass (see
core/project.py).

SH layout: sh[:, c, 0] = f_dc_c and sh[:, c, 1:16] = f_rest[c*15:(c+1)*15],
matching the channel-major coefficient layout the reference unpacks into
{r,g,b}_sh0..3 (ref: src/gaussiancloud.cpp:265-314).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from splatapult_tpu_torch._device import DEFAULT_DEVICE, resolve_device
from splatapult_tpu_torch.io.ply import PlyData, make_ply, read_ply, write_ply

_log = logging.getLogger("splatapult_tpu_torch")


@dataclasses.dataclass
class GaussianScene:
    """SoA splat parameters. All tensors share leading dim N (splat count).

    Fields mirror the INRIA trainer PLY schema the reference consumes
    (ref: src/gaussiancloud.cpp:170-228):
      means            [N, 3]    x, y, z
      sh               [N, 3, K] K = 1 (deg 0) or 16 (deg 3); see module docstring
      opacities        [N]       logit-opacity (alpha = sigmoid(opacities))
      log_scales       [N, 3]    scale = exp(log_scales)
      quats            [N, 4]    rotation quaternion, (w, x, y, z) = rot_0..3
    """

    means: torch.Tensor
    sh: torch.Tensor
    opacities: torch.Tensor
    log_scales: torch.Tensor
    quats: torch.Tensor

    @property
    def num_gaussians(self) -> int:
        return int(self.means.shape[0])

    @property
    def sh_degree(self) -> int:
        return {1: 0, 4: 1, 9: 2, 16: 3}[int(self.sh.shape[-1])]

    @property
    def has_full_sh(self) -> bool:
        return int(self.sh.shape[-1]) > 1

    def to(self, device) -> "GaussianScene":
        return GaussianScene(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
        })


def _scene_from_arrays(means, sh, opacities, log_scales, quats,
                       device) -> GaussianScene:
    def t(a):
        return torch.from_numpy(
            np.array(a, dtype=np.float32)).to(device)

    return GaussianScene(means=t(means), sh=t(sh), opacities=t(opacities),
                         log_scales=t(log_scales), quats=t(quats))


def scene_from_ply(ply: PlyData, use_full_sh: bool = True,
                   device=DEFAULT_DEVICE) -> GaussianScene:
    """Convert parsed PLY columns to a GaussianScene.

    ``use_full_sh=False`` reproduces the reference's ``--nosh`` degradation to
    degree-0 SH (ref: src/app.cpp:335, src/gaussiancloud.cpp:160-167).
    """
    device = resolve_device(device)
    n = ply.num_vertices
    means = ply.columns(["x", "y", "z"])
    opacities = ply.column("opacity").astype(np.float32)
    log_scales = ply.columns(["scale_0", "scale_1", "scale_2"])
    quats = ply.columns(["rot_0", "rot_1", "rot_2", "rot_3"])

    f_dc = ply.columns(["f_dc_0", "f_dc_1", "f_dc_2"])  # [N, 3]
    # degree-1/2/3 exports carry 9/24/45 f_rest coefficients (3 channels x
    # (K-1) coeffs, K in {4, 9, 16}); accept each at its stored degree
    # instead of silently degrading sub-degree-3 files to DC-only. The
    # reference hard-requires all 45 (its property map fails otherwise,
    # src/gaussiancloud.cpp:170-228); real-world degree-1/2 exports exist,
    # so this loader is deliberately more permissive.
    num_rest = 0
    while ply.has(f"f_rest_{num_rest}"):
        num_rest += 1
    k = next((kk for kk in (16, 9, 4) if num_rest >= 3 * (kk - 1)), 1)
    if num_rest not in (0, 9, 24, 45):
        _log.warning(
            "unusual f_rest count %d (expected 0/9/24/45); using the "
            "largest complete SH degree (K=%d)", num_rest, k)
    if k > 1 and use_full_sh:
        rest_per_ch = k - 1
        f_rest = ply.columns(
            [f"f_rest_{i}" for i in range(3 * rest_per_ch)])
        sh = np.empty((n, 3, k), np.float32)
        sh[:, :, 0] = f_dc
        # per-channel blocks of (K-1) (ref: src/gaussiancloud.cpp:265-314)
        for c in range(3):
            sh[:, c, 1:] = f_rest[:, c * rest_per_ch:(c + 1) * rest_per_ch]
    else:
        sh = f_dc[:, :, None]  # [N, 3, 1]
    return _scene_from_arrays(means, sh, opacities, log_scales, quats, device)


def load_gaussian_ply(path: str, use_full_sh: bool = True,
                      device=DEFAULT_DEVICE) -> GaussianScene:
    """Load a trainer .ply (ref: GaussianCloud::ImportPly, src/gaussiancloud.cpp:138)."""
    return scene_from_ply(read_ply(path), use_full_sh=use_full_sh, device=device)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def scene_to_ply(scene: GaussianScene, export_full_sh: bool = True) -> PlyData:
    """Inverse conversion; property order matches the reference exporter
    (ref: GaussianCloud::ExportPly, src/gaussiancloud.cpp:367-433) so written
    files are consumable by the same tools. Unlike the reference we never have
    to eigendecompose a baked covariance (ref: src/gaussiancloud.cpp:96-117) —
    the canonical state already is {quat, log-scale}."""
    means = _np(scene.means)
    sh = _np(scene.sh)
    n = means.shape[0]
    zeros = np.zeros(n, np.float32)
    cols = {
        "x": means[:, 0], "y": means[:, 1], "z": means[:, 2],
        "nx": zeros, "ny": zeros, "nz": zeros,
        "f_dc_0": sh[:, 0, 0], "f_dc_1": sh[:, 1, 0], "f_dc_2": sh[:, 2, 0],
    }
    if export_full_sh and scene.has_full_sh:
        rest_per_ch = sh.shape[-1] - 1  # 3 / 8 / 15 for K = 4 / 9 / 16
        for c in range(3):
            for i in range(rest_per_ch):
                cols[f"f_rest_{c * rest_per_ch + i}"] = sh[:, c, i + 1]
    cols["opacity"] = _np(scene.opacities)
    log_scales = _np(scene.log_scales)
    quats = _np(scene.quats)
    for i in range(3):
        cols[f"scale_{i}"] = log_scales[:, i]
    for i in range(4):
        cols[f"rot_{i}"] = quats[:, i]
    return make_ply(cols)


def save_gaussian_ply(path: str, scene: GaussianScene, export_full_sh: bool = True) -> None:
    write_ply(path, scene_to_ply(scene, export_full_sh=export_full_sh))


# SH degree-0 basis constant (ref: shader/splat_vert.glsl:65)
SH_C0 = 0.28209479177387814


def make_debug_scene(device=DEFAULT_DEVICE) -> GaussianScene:
    """Procedural RGB-axes + white-origin test scene, 16 splats.

    Same geometry/colors as the reference's debug cloud
    (ref: GaussianCloud::InitDebugCloud, src/gaussiancloud.cpp:505-578):
    5 splats per axis at spacing 0.2 with isotropic covariance 0.005, alpha 1.
    The reference stores baked covariance; we store the equivalent parameters:
    identity quat, log-scale = 0.5*log(0.005), opacity logit of ~1 (clamped).
    """
    device = resolve_device(device)
    num_per_axis = 5
    axis_len = 1.0
    delta = axis_len / num_per_axis
    cov_diag = 0.005
    sh_one = 1.0 / (2.0 * SH_C0)
    sh_zero = -1.0 / (2.0 * SH_C0)

    means, colors = [], []
    for axis in range(3):
        for i in range(num_per_axis):
            p = [0.0, 0.0, 0.0]
            p[axis] = (i + 1) * delta
            means.append(p)
            c = [sh_zero, sh_zero, sh_zero]
            c[axis] = sh_one
            colors.append(c)
    means.append([0.0, 0.0, 0.0])
    colors.append([sh_one, sh_one, sh_one])

    n = len(means)
    sh = np.zeros((n, 3, 16), np.float32)
    sh[:, :, 0] = np.asarray(colors, np.float32)
    # alpha=1 exactly has an infinite logit; use a large finite value
    # (sigmoid(12) = 0.9999938, visually identical).
    opacities = np.full((n,), 12.0, np.float32)
    log_scales = np.full((n, 3), 0.5 * np.log(cov_diag), np.float32)
    quats = np.tile(np.asarray([1.0, 0.0, 0.0, 0.0], np.float32), (n, 1))
    return _scene_from_arrays(means, sh, opacities, log_scales, quats, device)
