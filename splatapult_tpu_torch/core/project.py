"""EWA splat projection: 3D gaussians -> screen-space 2D gaussians + culling.

Re-derivation of the reference's vertex/geometry-shader math
(ref: shader/splat_vert.glsl:153-221, shader/splat_geom.glsl:34-87) and its
presort cull (ref: shader/presort_compute.glsl:42-56), as batched PyTorch
elementwise arithmetic over [N] splats.

Geometry conventions are GL: view space has -Z forward, clip w = -z_view,
screen coordinates have +y up with pixel centers at (i + 0.5, j + 0.5)
(gl_FragCoord semantics, which shader/splat_frag.glsl:20 relies on).

Numerical-parity constants, each cited where used:
  COV2D_DILATION = 0.3 px  (shader/splat_vert.glsl:193-196)
  EXTENT_SIGMA   = 3.5     (shader/splat_geom.glsl:58)
  PRESORT_CLIP   = 1.5     (shader/presort_compute.glsl:47)
  GUARD_NDC_Z    = 0.25, GUARD_NDC_XY = 2.0 (shader/splat_geom.glsl:48-51)
  ALPHA_CUTOFF   = 1/256   (shader/splat_frag.glsl:38) — applied in compositing
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from splatapult_tpu_torch.core.transforms import stack_last

COV2D_DILATION = 0.3
EXTENT_SIGMA = 3.5
PRESORT_CLIP = 1.5
GUARD_NDC_Z = 0.25
GUARD_NDC_XY = 2.0
ALPHA_CUTOFF = 1.0 / 256.0


class ProjectedSplats(NamedTuple):
    """Per-splat screen-space quantities, all leading dim [N]."""

    mean2d: torch.Tensor  # [N, 2] screen-space center in pixels (+y up)
    cov2d: torch.Tensor  # [N, 3] packed 2D covariance (a, b, c) = (xx, xy, yy)
    conic: torch.Tensor  # [N, 3] packed inverse covariance (A, B, C)
    depth: torch.Tensor  # [N] positive view depth (= clip w = -z_view)
    mask: torch.Tensor  # [N] bool, True = survives culling
    radius: torch.Tensor  # [N] EXTENT_SIGMA * sqrt(major eigenvalue), px (0 if culled)
    extent: torch.Tensor  # [N, 2] tight AABB half-extents (rx, ry), px (0 if culled)


def project_gaussians(
    means,  # [N, 3] world-space centers
    cov3,  # [N, 3, 3] world-space covariance
    view_mat,  # [4, 4] world -> view
    proj_mat,  # [4, 4] view -> clip (GL convention)
    viewport,  # (width, height) in pixels; offsets assumed 0
) -> ProjectedSplats:
    width, height = viewport

    # --- view transform t = V * p (ref: shader/splat_vert.glsl:157), as
    # explicit component sums (3-long contractions are elementwise work).
    # Component vectors are made contiguous once ([3, N] / [9, N] copies):
    # every following op is then a vectorized pass over [N] instead of a
    # strided read of one column of an [N, 3] or [N, 3, 3] array.
    mx, my_, mz = means.t().contiguous().unbind(0)
    cov_rows = cov3.reshape(-1, 9).t().contiguous()
    cov = [[cov_rows[3 * i + k] for k in range(3)] for i in range(3)]
    t = [view_mat[i, 0] * mx + view_mat[i, 1] * my_ + view_mat[i, 2] * mz + view_mat[i, 3]
         for i in range(3)]  # 3 x [N]
    tz = t[2]

    # --- perspective divide / NDC (ref: shader/splat_vert.glsl:200-203)
    def proj_row(i):
        return (proj_mat[i, 0] * t[0] + proj_mat[i, 1] * t[1]
                + proj_mat[i, 2] * t[2] + proj_mat[i, 3])

    w_clip = proj_row(3)  # = -tz for GL projections
    depth = w_clip
    safe_w = torch.where(w_clip.abs() < 1e-12, 1e-12, w_clip)
    ndc = [proj_row(i) / safe_w for i in range(3)]  # 3 x [N]

    mean2d = stack_last([
        0.5 * (width + ndc[0] * width),  # + X0 terms, offsets are 0
        0.5 * (height + ndc[1] * height),
    ])

    # --- Jacobian of projection+viewport at t (ref: shader/splat_vert.glsl:167-181).
    # Only the top-left 2x2 of the projected covariance is kept, and J's third
    # row contributes nothing to it, so the z row (jtz) is dropped entirely.
    sx = proj_mat[0, 0]
    sy = proj_mat[1, 1]
    safe_tz = torch.where(tz.abs() < 1e-12, 1e-12, tz)
    inv_tz = 1.0 / safe_tz
    inv_tz2 = inv_tz * inv_tz
    jsx = -(sx * width) * 0.5 * inv_tz
    jsy = -(sy * height) * 0.5 * inv_tz
    jtx = (sx * width) * 0.5 * t[0] * inv_tz2
    jty = (sy * height) * 0.5 * t[1] * inv_tz2

    # JW: rows of the 2x3 matrix [[jsx,0,jtx],[0,jsy,jty]] times W = view rotation.
    # All contractions are written as explicit component sums on [N] vectors.
    W = view_mat[:3, :3]
    jw0 = [jsx * W[0, k] + jtx * W[2, k] for k in range(3)]  # 3 x [N]
    jw1 = [jsy * W[1, k] + jty * W[2, k] for k in range(3)]
    # cov2d = (JW) V (JW)^T, top-left 2x2 (ref: shader/splat_vert.glsl:183-191)
    v0 = [sum(cov[i][k] * jw0[k] for k in range(3)) for i in range(3)]  # V (JW row0)^T
    v1 = [sum(cov[i][k] * jw1[k] for k in range(3)) for i in range(3)]
    a = sum(jw0[i] * v0[i] for i in range(3)) + COV2D_DILATION  # +0.3 px low-pass
    b = sum(jw0[i] * v1[i] for i in range(3))
    c = sum(jw1[i] * v1[i] for i in range(3)) + COV2D_DILATION
    cov2d = stack_last([a, b, c])

    # --- conic = inverse 2x2 (ref: shader/splat_geom.glsl:22-32)
    det = a * c - b * b
    safe_det = torch.where(det.abs() < 1e-24, 1e-24, det)
    inv_det = 1.0 / safe_det
    conic = stack_last([c * inv_det, -b * inv_det, a * inv_det])

    # --- culling: presort CLIP=1.5 + depth>0 (ref: shader/presort_compute.glsl:47-48)
    # and the geometry-shader guard band (ref: shader/splat_geom.glsl:46-54).
    mask = (
        (depth > 0.0)
        & (ndc[0].abs() < PRESORT_CLIP)
        & (ndc[1].abs() < PRESORT_CLIP)
        & (ndc[2] >= GUARD_NDC_Z)
        & (ndc[0].abs() <= GUARD_NDC_XY)
        & (ndc[1].abs() <= GUARD_NDC_XY)
        & (det > 0.0)
    )

    # --- screen extent from the covariance ellipse's major eigenvalue
    # (ref: shader/splat_geom.glsl:56-79). Only the scalar radius is needed for
    # tile binning; the reference's rotated-quad construction never clips any
    # pixel that passes the 1/256 alpha test (exp(-0.5 r^2) = 1/256 at r ~ 3.33
    # < 3.5 sigma), so a radius-based AABB is a strict superset of its coverage.
    mid = 0.5 * (a + c)
    term = torch.sqrt(torch.clamp_min(0.25 * (a - c) ** 2 + b * b, 0.0))
    lambda_max = mid + term
    radius = EXTENT_SIGMA * torch.sqrt(torch.clamp_min(lambda_max, 0.0))
    radius = torch.where(mask, radius, 0.0)

    # Tight axis-aligned half-extents: the k-sigma ellipse spans exactly
    # +- k*sqrt(Sigma_xx) in x (and ..._yy in y), which is never larger than
    # the lambda_max square — fewer tile instances for anisotropic splats at
    # identical coverage (the 3.33-sigma discard radius stays inside 3.5).
    rx = EXTENT_SIGMA * torch.sqrt(torch.clamp_min(a, 0.0))
    ry = EXTENT_SIGMA * torch.sqrt(torch.clamp_min(c, 0.0))
    extent = torch.where(mask[:, None], stack_last([rx, ry]), 0.0)

    return ProjectedSplats(
        mean2d=mean2d, cov2d=cov2d, conic=conic, depth=depth, mask=mask,
        radius=radius, extent=extent,
    )


def view_dirs(means, eye):
    """Unit directions from the eye to each splat, for SH evaluation
    (ref: shader/splat_vert.glsl:205-206)."""
    d = means - eye[None, :]
    n = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return d / torch.clamp_min(n, 1e-12)
