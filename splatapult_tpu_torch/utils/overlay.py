"""Camera frustum / path overlay: the reference's CameraPathRenderer as a
post-process line rasterizer over rendered images.

Builds the same geometry (ref: src/camerapathrenderer.cpp): an 8-line frustum
wireframe per camera from its fov (BuildCamerasVao, 78-147) and a polyline
through consecutive camera centers (BuildPathVao, 149-204), then draws the
lines into the image with a numpy Bresenham-style rasterizer instead of a GL
line pipeline (shader/debugdraw_*.glsl). Host-side numpy: draw onto a
rendered image after it has been read back.
"""

from __future__ import annotations

import numpy as np

FRUSTUM_DEPTH = 0.2  # world-space frustum visualization depth
CAMERA_COLOR = (1.0, 1.0, 1.0)
PATH_COLOR = (1.0, 1.0, 0.0)


def _frustum_segments(cam_to_world, fovx, fovy, depth=FRUSTUM_DEPTH):
    """8 line segments (eye->corners, corner loop) for one camera."""
    tx, ty = np.tan(fovx / 2.0) * depth, np.tan(fovy / 2.0) * depth
    corners_cam = np.asarray(
        [[-tx, -ty, -depth], [tx, -ty, -depth], [tx, ty, -depth], [-tx, ty, -depth]]
    )
    R, t = cam_to_world[:3, :3], cam_to_world[:3, 3]
    corners = corners_cam @ R.T + t
    segs = []
    for i in range(4):
        segs.append((t, corners[i]))  # eye -> corner (4 lines)
        segs.append((corners[i], corners[(i + 1) % 4]))  # corner loop (4 lines)
    return segs


def camera_overlay_lines(cameras, show_frustums: bool = True, show_path: bool = True):
    """[(p0, p1, rgb)] world-space segments for a list of io.configs.CameraInfo.

    Frustums toggled like the reference's 'y' key, the path polyline like 'h'
    (ref: src/app.cpp:684-698).
    """
    segs = []
    if show_frustums:
        for c in cameras:
            for p0, p1 in _frustum_segments(c.cam_to_world, c.fov[0], c.fov[1]):
                segs.append((p0, p1, CAMERA_COLOR))
    if show_path:
        for a, b in zip(cameras[:-1], cameras[1:]):
            segs.append((a.position, b.position, PATH_COLOR))
    return segs


def draw_lines(img, segments, view_cam_to_world, proj, width: int, height: int):
    """Rasterize world-space segments into [H, W, >=3] image (in place copy).

    Projects endpoints with the same GL conventions as the splat pipeline and
    draws with sub-sampled points (adequate for an overlay; no AA).
    """
    img = np.array(img, np.float32, copy=True)
    view = np.linalg.inv(np.asarray(view_cam_to_world, np.float64))
    proj = np.asarray(proj, np.float64)

    def project(p):
        t = view[:3, :3] @ p + view[:3, 3]
        clip = proj @ np.append(t, 1.0)
        if clip[3] <= 1e-9:
            return None
        ndc = clip[:3] / clip[3]
        x = 0.5 * (width + ndc[0] * width)
        y = 0.5 * (height + ndc[1] * height)
        return np.asarray([x, height - y])  # to row-major image coords

    for p0, p1, color in segments:
        a = project(np.asarray(p0, np.float64))
        b = project(np.asarray(p1, np.float64))
        if a is None or b is None:
            continue
        n = int(max(abs(b[0] - a[0]), abs(b[1] - a[1]), 1)) + 1
        ts = np.linspace(0.0, 1.0, n)
        pts = a[None, :] * (1 - ts[:, None]) + b[None, :] * ts[:, None]
        cols = np.clip(pts[:, 0].astype(np.int64), 0, width - 1)
        rows = np.clip(pts[:, 1].astype(np.int64), 0, height - 1)
        inside = (pts[:, 0] >= 0) & (pts[:, 0] < width) & (pts[:, 1] >= 0) & (pts[:, 1] < height)
        img[rows[inside], cols[inside], :3] = np.asarray(color, np.float32)
        if img.shape[-1] > 3:
            img[rows[inside], cols[inside], 3] = 1.0
    return img
