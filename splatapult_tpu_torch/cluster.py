"""Camera-path rendering with SHARED tile binning across view clusters.

stereo.render_stereo bins once for a view PAIR: the union of both views'
lossless tile rects with one shared depth, each view composited with its own
exact features. This module generalizes it to K consecutive views of a camera
path (the reference's `n`/`p` camera cycling, ref: src/app.cpp:650-674). The
counterpart of splatapult_tpu/cluster.py, function for function; per-view
rendering (render.render_batch) stays the default, and PERF.md section 6
holds what each costs on an H100.

What is exact and what is not:

- **Rect union** is lossless as in stereo: union rects only add instances
  whose per-pixel weights the composite zeroes (the 1/256 cutoff).
- **The shared depth is an APPROXIMATION here.** Stereo's eyes differ by an
  in-plane translation, which leaves view depth invariant; path steps also
  move along the view axis and rotate, so every view composites in the
  REFERENCE view's (view 0's) front-to-back order. Two splats composite in
  the wrong order for another view only where their depth separation is
  smaller than the depth perturbation of the pose delta (|dz| + O(theta r)).
  The gate (cluster_shareable) bounds it; cluster_size=1 is exact per-view
  rendering. A splat behind view 0 carries its negative depth into the key,
  which the binning clamps to 0: it sorts first in every tile it covers.
- **Per-view cull masks** as in stereo: a splat culled in one view rides the
  shared lists with conic = 0 and alpha = 0 there, contributing exactly zero.

stereo.py's functions are this module's on a stereo pair. As there, the grid is built at ``config.width x config.height`` and
``supersample > 1`` raises ``ValueError`` (ROADMAP queue 3).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from splatapult_tpu_torch.ops.binning import bin_splats, instance_demand
from splatapult_tpu_torch.ops.composite import composite_from_feats
from splatapult_tpu_torch.ops.tiled import _grid_from_config, assemble_image, pack_features
from splatapult_tpu_torch.render import (
    CAPACITY_BUCKET,
    Camera,
    RenderConfig,
    capacity_mult_for_demand,
    prepare_splats,
    render,
)


def _check_supersample(config: RenderConfig, what: str) -> None:
    if config.supersample > 1:
        raise ValueError(
            f"{what}: shared binning renders at the output size; supersample="
            f"{config.supersample} is not applied there (render each view with "
            f"render.render_batch to supersample)")


def _interval_union(c_a, r_a, c_b, r_b):
    """Union of per-splat 1-D intervals [c - r, c + r]; r <= 0 marks an empty
    interval (culled in that view). Both empty -> (0, 0) = culled. The same
    f32 operations as the JAX package's, so the same bits."""
    live_a = r_a > 0.0
    live_b = r_b > 0.0
    big = 3.4e38
    lo = torch.minimum(torch.where(live_a, c_a - r_a, big),
                       torch.where(live_b, c_b - r_b, big))
    hi = torch.maximum(torch.where(live_a, c_a + r_a, -big),
                       torch.where(live_b, c_b + r_b, -big))
    any_live = live_a | live_b
    c = torch.where(any_live, 0.5 * (lo + hi), 0.0)
    r = torch.where(any_live, 0.5 * (hi - lo), 0.0)
    return c, r


def union_rects(ds):
    """Per-view splat dicts -> (union_mean2d [N, 2], union_extent [N, 2]):
    the rect that covers every view's rect, folded view by view in order
    (detached: binning geometry)."""
    ux, rx = ds[0]["mean2d"][:, 0].detach(), ds[0]["extent"][:, 0]
    uy, ry = ds[0]["mean2d"][:, 1].detach(), ds[0]["extent"][:, 1]
    for d in ds[1:]:
        ux, rx = _interval_union(ux, rx, d["mean2d"][:, 0].detach(), d["extent"][:, 0])
        uy, ry = _interval_union(uy, ry, d["mean2d"][:, 1].detach(), d["extent"][:, 1])
    return torch.stack([ux, uy], dim=1), torch.stack([rx, ry], dim=1)


def shared_features(d) -> torch.Tensor:
    """One view's feature rows for shared bins ([N + 1, 16], pack_features).
    A splat culled in THIS view may ride the shared lists: its conic is
    zeroed (its projection can be ill-conditioned behind the guard band) so
    its exponent is ln(alpha) = ln(1e-37), under the discard; torch.where
    passes no gradient to the culled conic."""
    conic = torch.where(d["mask"][:, None], d["conic"], 0.0)
    return pack_features(d["mean2d"], conic, d["rgb"], d["alpha"])


def composite_shared(d, bins, grid, config: RenderConfig) -> torch.Tensor:
    """One view's image through shared bins -> [H, W, 4]."""
    out = composite_from_feats(shared_features(d), bins, grid)
    return assemble_image(out, bins["tile_ok"], grid, config)


def _view_camera(cameras: Camera, i: int) -> Camera:
    return Camera(cam_to_world=cameras.cam_to_world[i], proj=cameras.proj[i])


def _slice_cameras(cameras: Camera, a: int, b: int) -> Camera:
    return Camera(cam_to_world=cameras.cam_to_world[a:b], proj=cameras.proj[a:b])


def prepare_cluster(scene, cameras: Camera, config: RenderConfig):
    """Per-view splat dicts + the union binning geometry of a [K]-batched
    camera -> (list of per-view dicts, union_mean2d, union_extent); the
    shared binning depth is view 0's (the cluster's reference)."""
    ds = [prepare_splats(scene, _view_camera(cameras, i), config, sort=False)
          for i in range(cameras.cam_to_world.shape[0])]
    return (ds, *union_rects(ds))


def render_cluster(scene, cameras: Camera, config: RenderConfig) -> torch.Tensor:
    """Render a [K]-batched camera cluster with ONE shared binning ->
    [K, H, W, 4]: one bin_splats on the union rects with view 0's depth,
    then each view's composite on the shared bins. Differentiable: each
    view's gradients sum onto the shared scene. Reads nothing back."""
    _check_supersample(config, "render_cluster")
    ds, union_mean2d, union_extent = prepare_cluster(scene, cameras, config)
    grid = _grid_from_config(config, union_mean2d.shape[0])
    bins = bin_splats(union_mean2d, union_extent, grid, depth=ds[0]["depth"].detach())
    return torch.stack([composite_shared(d, bins, grid, config) for d in ds])


def cluster_instance_demand(scene, cameras: Camera, config: RenderConfig) -> torch.Tensor:
    """Tile-instance demand of a cluster's SHARED binning -> scalar int32
    tensor (no readback)."""
    _, union_mean2d, union_extent = prepare_cluster(scene, cameras, config)
    grid = _grid_from_config(config, scene.means.shape[0])
    return instance_demand(union_mean2d, union_extent, grid)


def calibrate_config_cluster(scene, cameras: Camera, config: RenderConfig,
                             cluster_size: int = 4, headroom: float = 1.06,
                             bucket: float | None = None) -> RenderConfig:
    """Size the capacity for the peak UNION demand over the path's clusters
    of ``cluster_size`` consecutive views (a single view's demand undersizes
    a shared binning), bucketed as render.calibrate_config buckets. Reads one
    scalar back per cluster."""
    _check_supersample(config, "calibrate_config_cluster")
    v = cameras.cam_to_world.shape[0]
    peak = 0
    with torch.no_grad():
        for c0 in range(0, v, cluster_size):
            sub = _slice_cameras(cameras, c0, min(c0 + cluster_size, v))
            peak = max(peak, int(cluster_instance_demand(scene, sub, config).item()))
    mult = capacity_mult_for_demand(peak, scene.means.shape[0], config, headroom,
                                    CAPACITY_BUCKET if bucket is None else bucket)
    return dataclasses.replace(config, max_instance_mult=mult)


def scene_depth_scale(scene) -> float:
    """Rotation-to-depth lever arm for the gate: the 99th-percentile splat
    distance from the scene centroid, in world units (a rotation theta
    perturbs the depth of content at radius r by up to ~theta r). Computed in
    numpy on a host copy of the means, with the JAX package's operations in
    its order (f32 mean, f32 norms, np.percentile), so the value is its
    value: one readback of ``means``."""
    means = scene.means.detach().cpu().numpy()
    c = means.mean(axis=0)
    return float(np.percentile(np.linalg.norm(means - c, axis=1), 99.0))


def cluster_shareable(cameras: Camera, max_depth_shift: float, r_scale: float = 1.0) -> bool:
    """Conservative host-side gate: every non-reference view's pose must stay
    depth-compatible with the reference view's front-to-back order.

    The depth perturbation of a pose delta on a splat at distance r is |dz|
    (translation along the reference view axis) plus up to theta r
    (rotation by theta); with r bounded by the content radius ``r_scale``
    (scene_depth_scale) the gate is |dz| + theta r_scale <= max_depth_shift,
    in world units. numpy on a host copy of the pose matrices, as the JAX
    package computes it, so each decision is its decision."""
    mats = cameras.cam_to_world.detach().cpu().numpy()
    ref = mats[0]
    fwd = -ref[:3, 2]  # GL convention: -Z forward
    for m in mats[1:]:
        dz = abs(float(np.dot(m[:3, 3] - ref[:3, 3], fwd)))
        rot = ref[:3, :3].T @ m[:3, :3]
        cos_t = np.clip((np.trace(rot) - 1.0) / 2.0, -1.0, 1.0)
        # f32 pose matrices put identical rotations ~1e-7 below trace 3;
        # arccos amplifies that to ~5e-4 rad: snap that noise to zero
        theta = 0.0 if cos_t > 1.0 - 1e-6 else float(np.arccos(cos_t))
        if dz + theta * r_scale > max_depth_shift:
            return False
    return True


def render_path_clustered(scene, cameras: Camera, config: RenderConfig,
                          cluster_size: int = 4,
                          max_depth_shift: float | str | None = "auto") -> torch.Tensor:
    """Render a [V]-batched camera path, sharing binning across clusters of
    ``cluster_size`` consecutive views -> [V, H, W, 4].

    A cluster the gate refuses (cluster_shareable) renders each of its views
    with render.render. ``"auto"`` gates at 0.5 % of the scene's content
    radius with that radius as the rotation lever arm (scene_depth_scale: one
    readback of ``means`` per call); ``None`` shares every cluster without
    the gate; cluster_size=1 is per-view rendering. With cluster_size > 1,
    ``supersample > 1`` raises ValueError, whatever the gate decides."""
    if cluster_size > 1:
        _check_supersample(config, "render_path_clustered")
    r_scale = 1.0
    if max_depth_shift == "auto":
        r_scale = max(scene_depth_scale(scene), 1e-6)
        max_depth_shift = 0.005 * r_scale
    v = cameras.cam_to_world.shape[0]
    outs = []
    for c0 in range(0, v, cluster_size):
        sub = _slice_cameras(cameras, c0, min(c0 + cluster_size, v))
        k = sub.cam_to_world.shape[0]
        share = k > 1 and (max_depth_shift is None
                           or cluster_shareable(sub, max_depth_shift, r_scale))
        if share:
            outs.append(render_cluster(scene, sub, config))
        else:
            outs.append(torch.stack([render(scene, _view_camera(sub, i), config)
                                     for i in range(k)]))
    return torch.cat(outs, dim=0)
