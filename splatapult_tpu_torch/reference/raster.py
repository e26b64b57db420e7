"""Oracle rasterizer: slow, obviously-correct, float64 numpy, O(N * P).

This is the correctness target the reference repo never had (it ships no tests;
ref: SURVEY.md section 4). It re-implements the full splat pipeline —
SH radiance (shader/splat_vert.glsl:51-127), EWA projection
(shader/splat_vert.glsl:153-203), culling (shader/presort_compute.glsl:47-48,
shader/splat_geom.glsl:46-54), back-to-front "over" blending with premultiplied
alpha (shader/splat_frag.glsl:18-42 + GL blend state src/app.cpp:153-156) —
independently of the production PyTorch/CUDA code, in float64, with explicit
per-pixel loops over every splat. Deliberately shares no code with
core/ or ops/ so it can catch their bugs. (The JAX package holds the same
oracle; this copy keeps the port free of any import from it.)
"""

from __future__ import annotations

import numpy as np

_SH_CONSTS = dict(
    k0=0.28209479177387814,
    k1=0.4886025119029199,
    k2=1.0925484305920792,
    k3=0.31539156525252005,
    k4=0.5462742152960396,
    k5=0.5900435899266435,
    k6=2.8906114426405543,
    k7=0.4570457994644658,
    k8=0.37317633259011546,
    k9=1.4453057213202771,
)


def _sh_radiance(sh, dirs):
    """sh [N, 3, K], dirs [N, 3] unit -> rgb [N, 3]; mirrors splat_vert.glsl:51-127."""
    n, _, k_stored = sh.shape
    x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    x2, y2, z2 = x * x, y * y, z * z
    c = _SH_CONSTS
    b = np.zeros((n, 16))
    b[:, 0] = c["k0"]
    if k_stored > 1:
        b[:, 1] = -c["k1"] * y
        b[:, 2] = c["k1"] * z
        b[:, 3] = -c["k1"] * x
        b[:, 4] = c["k2"] * y * x
        b[:, 5] = -c["k2"] * y * z
        b[:, 6] = c["k3"] * (3.0 * z2 - 1.0)
        b[:, 7] = -c["k2"] * x * z
        b[:, 8] = c["k4"] * (x2 - y2)
        b[:, 9] = -c["k5"] * y * (3.0 * x2 - y2)
        b[:, 10] = c["k6"] * y * x * z
        b[:, 11] = -c["k7"] * y * (5.0 * z2 - 1.0)
        b[:, 12] = c["k8"] * z * (5.0 * z2 - 3.0)
        b[:, 13] = -c["k7"] * x * (5.0 * z2 - 1.0)
        b[:, 14] = c["k9"] * z * (x2 - y2)
        b[:, 15] = -c["k5"] * x * (x2 - 3.0 * y2)
    return 0.5 + np.einsum("nck,nk->nc", sh, b[:, :k_stored])


def _quat_rotmat(q):
    """(w, x, y, z) [N, 4] -> [N, 3, 3], normalizing first (gaussiancloud.cpp:88)."""
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = np.empty((q.shape[0], 3, 3))
    R[:, 0, 0] = 1 - 2 * (y * y + z * z)
    R[:, 0, 1] = 2 * (x * y - w * z)
    R[:, 0, 2] = 2 * (x * z + w * y)
    R[:, 1, 0] = 2 * (x * y + w * z)
    R[:, 1, 1] = 1 - 2 * (x * x + z * z)
    R[:, 1, 2] = 2 * (y * z - w * x)
    R[:, 2, 0] = 2 * (x * z - w * y)
    R[:, 2, 1] = 2 * (y * z + w * x)
    R[:, 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def reference_render(
    means,  # [N, 3]
    sh,  # [N, 3, K]
    opacities,  # [N] logits
    log_scales,  # [N, 3]
    quats,  # [N, 4] wxyz
    cam_to_world,  # [4, 4]
    proj_mat,  # [4, 4] GL convention
    width: int,
    height: int,
    alpha_cutoff: float = 1.0 / 256.0,  # shader/splat_frag.glsl:38; 0 = no discard
) -> np.ndarray:
    """Render [H, W, 4] premultiplied RGBA, row 0 = top. float64 throughout."""
    means = np.asarray(means, np.float64)
    sh = np.asarray(sh, np.float64)
    alpha = 1.0 / (1.0 + np.exp(-np.asarray(opacities, np.float64)))
    scales = np.exp(np.asarray(log_scales, np.float64))
    quats = np.asarray(quats, np.float64)
    cam_to_world = np.asarray(cam_to_world, np.float64)
    proj = np.asarray(proj_mat, np.float64)

    n = means.shape[0]
    view = np.linalg.inv(cam_to_world)
    eye = cam_to_world[:3, 3]

    # bake covariance: cov = R S S^T R^T (gaussiancloud.cpp:86-94)
    R = _quat_rotmat(quats)
    cov3 = np.einsum("nik,nk,njk->nij", R, scales**2, R)

    # radiance from SH along eye->splat dirs (splat_vert.glsl:205-207)
    dirs = means - eye[None, :]
    dirs = dirs / np.maximum(np.linalg.norm(dirs, axis=-1, keepdims=True), 1e-300)
    rgb = _sh_radiance(sh, dirs)

    # project
    t = means @ view[:3, :3].T + view[:3, 3]
    clip = np.concatenate([t, np.ones((n, 1))], axis=1) @ proj.T
    w_clip = clip[:, 3]
    with np.errstate(divide="ignore", invalid="ignore"):
        ndc = clip[:, :3] / w_clip[:, None]
    sx_pix = 0.5 * (width + ndc[:, 0] * width)
    sy_pix = 0.5 * (height + ndc[:, 1] * height)

    # EWA jacobian (splat_vert.glsl:167-188)
    SX, SY = proj[0, 0], proj[1, 1]
    tz = t[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        jsx = -(SX * width) / (2.0 * tz)
        jsy = -(SY * height) / (2.0 * tz)
        jtx = (SX * width) * t[:, 0] / (2.0 * tz**2)
        jty = (SY * height) * t[:, 1] / (2.0 * tz**2)
    cov2 = np.empty((n, 2, 2))
    Wr = view[:3, :3]
    for i in range(n):  # explicit per-splat loop: clarity over speed
        J2 = np.array([[jsx[i], 0.0, jtx[i]], [0.0, jsy[i], jty[i]]])
        JW = J2 @ Wr
        cov2[i] = JW @ cov3[i] @ JW.T
    cov2[:, 0, 0] += 0.3  # low-pass dilation (splat_vert.glsl:195)
    cov2[:, 1, 1] += 0.3

    # culling: presort CLIP (presort_compute.glsl:47-48) + guard band (splat_geom.glsl:46-54)
    keep = (
        (w_clip > 0)
        & (np.abs(ndc[:, 0]) < 1.5)
        & (np.abs(ndc[:, 1]) < 1.5)
        & (ndc[:, 2] >= 0.25)
        & (np.abs(ndc[:, 0]) <= 2.0)
        & (np.abs(ndc[:, 1]) <= 2.0)
    )

    # back-to-front order by view depth (presort_compute.glsl:52-53: ascending
    # key = back-to-front; equivalently descending depth, stable)
    order = np.argsort(-w_clip, kind="stable")
    order = [i for i in order if keep[i]]

    out = np.zeros((height, width, 4))
    px = np.arange(width) + 0.5
    py_img = height - (np.arange(height) + 0.5)  # row 0 = top, gl y-up coords
    gx, gy = np.meshgrid(px, py_img)

    for i in order:
        det = cov2[i, 0, 0] * cov2[i, 1, 1] - cov2[i, 0, 1] * cov2[i, 1, 0]
        if det <= 0:
            continue
        inv = np.linalg.inv(cov2[i])
        dx = gx - sx_pix[i]
        dy = gy - sy_pix[i]
        # g = exp(-0.5 d^T Sigma^-1 d) (splat_frag.glsl:20-25)
        g = np.exp(-0.5 * (inv[0, 0] * dx * dx + (inv[0, 1] + inv[1, 0]) * dx * dy + inv[1, 1] * dy * dy))
        w = alpha[i] * g
        if alpha_cutoff > 0.0:
            w = np.where(w > alpha_cutoff, w, 0.0)  # discard (splat_frag.glsl:38-41)
        # premultiplied src over dst (app.cpp:153-156: GL_ONE, ONE_MINUS_SRC_ALPHA)
        src_rgb = w[..., None] * rgb[i][None, None, :]
        out[..., :3] = src_rgb + (1.0 - w[..., None]) * out[..., :3]
        out[..., 3] = w + (1.0 - w) * out[..., 3]
    return out
