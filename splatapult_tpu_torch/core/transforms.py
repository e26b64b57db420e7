"""Camera, projection, rotation and color-space math.

Covers the math utilities of the reference's util layer (ref: src/core/util.cpp)
and the parameter-to-covariance bake of its scene import
(ref: src/gaussiancloud.cpp:86-94): quaternion -> rotation, cov = R S S^T R^T,
OpenGL-convention projection matrices (including the infinite-far and asymmetric
tan-angle variants of CreateProjection, ref: src/core/util.cpp:412-480), and
sRGB -> linear conversion (ref: src/core/util.cpp:357-402).

Per-splat functions (normalize, quat_to_rotmat, bake_covariance,
srgb_to_linear) and invert_rigid take and return torch tensors on the
caller's device. The camera-matrix constructors (look_at, perspective,
projection_from_tan_angles) are host math on a handful of scalars and return
float32 numpy [4, 4] arrays; render.Camera places them on a device.

Conventions (identical to the reference / OpenGL):
- camera-to-world matrices ("cameraMat") have -Z forward, +Y up, +X right;
  the view matrix is their inverse.
- clip space is right-handed GL: visible points have view-space z < 0,
  NDC in [-1, 1]^3.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def stack_last(cols) -> torch.Tensor:
    """[...]-shaped tensors -> contiguous [..., len(cols)], values as
    ``torch.stack(cols, dim=-1)``. Stacked along dim 0 (plain contiguous
    copies) and then transposed in one copy: concatenating one element at a
    time along the last dim is the slowest path of the CUDA cat kernel."""
    return torch.stack(cols, dim=0).movedim(0, -1).contiguous()


def normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Safe normalize along the last axis."""
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.clamp_min(n, eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) [..., 4] -> rotation matrix [..., 3, 3].

    Normalizes first, matching glm::mat3(glm::normalize(q)) in the reference
    covariance bake (ref: src/gaussiancloud.cpp:88-89).
    """
    q = normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    rows = stack_last([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ])
    return rows.reshape(*rows.shape[:-1], 3, 3)


def bake_covariance(quats: torch.Tensor, log_scales: torch.Tensor) -> torch.Tensor:
    """{quat, log-scale} -> 3x3 covariance, cov = R S S^T R^T.

    The equivalent of the reference's import-time bake
    (ref: ComputeCovMatFromRotScale, src/gaussiancloud.cpp:86-94, with
    scale = exp(log_scale) per src/gaussiancloud.cpp:334-340).
    """
    R = quat_to_rotmat(quats)  # [..., 3, 3]
    s2 = torch.exp(2.0 * log_scales)  # diag of S S^T
    # cov[i, j] = sum_k R[i, k] s2[k] R[j, k], as one broadcast product and a
    # 3-long sum: millions of 3x3 products are elementwise work, not a GEMM
    rs = R * s2[..., None, :]
    return (rs[..., :, None, :] * R[..., None, :, :]).sum(dim=-1)


def invert_rigid(mat: torch.Tensor) -> torch.Tensor:
    """Fast inverse of a rigid (rotation + translation) 4x4."""
    R = mat[..., :3, :3]
    t = mat[..., :3, 3]
    Rt = R.transpose(-1, -2)
    inv = torch.zeros_like(mat)
    inv[..., :3, :3] = Rt
    inv[..., :3, 3] = -(Rt * t[..., None, :]).sum(-1)
    inv[..., 3, 3] = 1.0
    return inv


def _unit(v: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), eps)


def look_at(eye, target, up) -> np.ndarray:
    """Camera-to-world matrix with -Z pointing from eye toward target (GL
    style) -> float32 numpy [4, 4]."""
    eye = np.asarray(eye, np.float32)
    fwd = _unit(np.asarray(target, np.float32) - eye)
    right = _unit(np.cross(fwd, np.asarray(up, np.float32)))
    true_up = np.cross(right, fwd)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0] = right
    m[:3, 1] = true_up
    m[:3, 2] = -fwd
    m[:3, 3] = eye
    return m


def perspective(fovy: float, aspect: float, near: float, far: float) -> np.ndarray:
    """Symmetric GL projection from vertical FOV (radians). far <= near =>
    infinite far plane. Host math: no device round trip at camera
    construction."""
    tan_half = math.tan(fovy / 2.0)
    return projection_from_tan_angles(
        -tan_half * aspect, tan_half * aspect, tan_half, -tan_half, near, far
    )


def projection_from_tan_angles(tan_left, tan_right, tan_up, tan_down,
                               near, far) -> np.ndarray:
    """GL projection from asymmetric view-frustum tangents -> float32 [4, 4].

    Re-derivation of the reference's CreateProjection for the GRAPHICS_OPENGL
    branch (ref: src/core/util.cpp:412-480): offsetZ = nearZ, Y up, [-1,1] z
    clip space; far <= near places the far plane at infinity.
    """
    tw = tan_right - tan_left
    th = tan_up - tan_down
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = 2.0 / tw
    m[0, 2] = (tan_right + tan_left) / tw
    m[1, 1] = 2.0 / th
    m[1, 2] = (tan_up + tan_down) / th
    if far <= near:
        m[2, 2] = -1.0
        m[2, 3] = -2.0 * near
    else:
        m[2, 2] = -(far + near) / (far - near)
        m[2, 3] = -(2.0 * far * near) / (far - near)
    m[3, 2] = -1.0
    return m


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    """Per-channel sRGB -> linear (ref: src/core/util.cpp:357-375,
    shader/splat_vert.glsl:130-140)."""
    return torch.where(
        c <= 0.04045, c / 12.92,
        torch.pow(torch.clamp_min((c + 0.055) / 1.055, 0.0), 2.4))
