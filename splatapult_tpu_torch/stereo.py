"""Stereo rendering with SHARED tile binning.

The reference sorts once per frame and renders both eyes from the same sorted
order (ref: src/app.cpp:603-607). The tiled pipeline's analog shares the
*binning*: bin once over the UNION of the two eyes' tile rects with one view
depth, then composite each eye through the same instance lists with its own
exact per-eye features. The counterpart of splatapult_tpu/stereo.py, function
for function; the per-eye path (Camera.stereo_pair + render.render_batch)
stays the default, and PERF.md section 6 holds what each costs on an H100.

Why each eye's image is that eye's own render (with the default alpha
cutoff), not an approximation:

- **Rect union.** The per-eye tile rect is the lossless opacity-tightened
  AABB (render.prepare_splats): every pixel outside it fails the reference's
  1/256 discard (shader/splat_frag.glsl:38-41). A superset rect therefore
  adds only instances whose per-pixel weights the composite zeroes, so each
  eye composites the same (instance, pixel) terms as per-eye binning would.
- **Shared depth.** The eyes differ by a translation along the camera-right
  axis; view-space z is invariant to it, so the front-to-back order is
  common to both eyes. (The two eyes' depths can differ by an ulp through
  the view-matrix inversion; the shared order resolves such near-ties by the
  index tie-break.)
- **Per-eye cull masks.** A splat culled in one eye but visible in the other
  rides the shared list; that eye's feature row gets conic = 0 and
  alpha = 0, so its exponent is ln(1e-37) ~ -85, under the discard at every
  pixel: it contributes exactly zero, and gets exactly zero gradient.

What differs from per-eye rendering is the float association: shared lists
are longer, so the composite kernel's 8-block segments fall elsewhere in a
tile's chain, and a weight at the 1/256 edge can flip.

A stereo pair is a cluster of two views (cluster.py) whose reference view
is the left eye: each function here is cluster.py's on
``camera.stereo_pair(ipd)``, so the pipeline and the capacity rule live in
one place. The grid is built at ``config.width x config.height``;
``supersample`` and ``pipeline`` are not read. The JAX package ignores
``supersample`` here (its image comes out at the output size without the box
filter); the port raises ``ValueError`` for ``supersample > 1`` instead
(ROADMAP queue 3).
"""

from __future__ import annotations

import torch

# _interval_union and union_rects keep their JAX package home's names here
from splatapult_tpu_torch.cluster import (  # noqa: F401
    _interval_union,
    _view_camera,
    calibrate_config_cluster,
    cluster_instance_demand,
    prepare_cluster,
    render_cluster,
    union_rects,
)
from splatapult_tpu_torch.render import Camera, RenderConfig


def _eye_cameras(camera: Camera, ipd) -> tuple[Camera, Camera]:
    """The two eyes of camera.stereo_pair(ipd) (symmetric frusta), as two
    single cameras."""
    eyes = camera.stereo_pair(ipd)
    return _view_camera(eyes, 0), _view_camera(eyes, 1)


def stereo_prepare(scene, camera: Camera, config: RenderConfig, ipd=0.064):
    """Per-eye splat dicts + the shared binning geometry -> (splats_left,
    splats_right, union_mean2d, union_extent). The union rect covers both
    eyes' lossless rects; the shared depth is splats_left["depth"]."""
    (d_l, d_r), union_mean2d, union_extent = prepare_cluster(scene, camera.stereo_pair(ipd),
                                                             config)
    return d_l, d_r, union_mean2d, union_extent


def render_stereo(scene, camera: Camera, config: RenderConfig, ipd=0.064) -> torch.Tensor:
    """Render a stereo pair with ONE shared binning -> [2, H, W, 4].

    One bin_splats on the union rects with the left eye's depth, then per
    eye the composite on the shared bins. Differentiable through each eye's
    features; autograd sums both eyes onto the scene. Reads nothing back."""
    return render_cluster(scene, camera.stereo_pair(ipd), config)


def stereo_instance_demand(scene, camera: Camera, config: RenderConfig,
                           ipd=0.064) -> torch.Tensor:
    """Tile-instance demand of the SHARED stereo binning -> scalar int32
    tensor (no readback)."""
    return cluster_instance_demand(scene, camera.stereo_pair(ipd), config)


def calibrate_config_stereo(scene, camera: Camera, config: RenderConfig, ipd=0.064,
                            headroom: float = 1.06,
                            bucket: float | None = None) -> RenderConfig:
    """render.calibrate_config for the shared stereo binning: the capacity
    from the UNION demand of both eyes (a single eye's demand undersizes it),
    bucketed onto render.CAPACITY_BUCKET's grid (bucket=1.0 for exact).
    Reads one scalar back."""
    return calibrate_config_cluster(scene, camera.stereo_pair(ipd), config, cluster_size=2,
                                    headroom=headroom, bucket=bucket)
