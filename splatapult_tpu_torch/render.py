"""The forward render pipeline: bake -> project -> cull -> bin/sort -> composite.

This is the functional re-architecture of the reference's per-frame GPU pipeline
(ref: src/splatrenderer.cpp:153-343 orchestrating presort_compute.glsl,
multi_radixsort*.glsl and the splat_vert/geom/frag chain):

    image = render(scene, camera, config)        # eager PyTorch, one view

Differences by design, not translation:
- No host<->device sync: the reference reads back an atomic splat counter every
  frame (ref: src/splatrenderer.cpp:196-204); here culled splats are masked and
  every buffer has a static capacity.
- Front-to-back transmittance compositing per tile replaces hardware
  back-to-front "over" blending (ref: src/app.cpp:153-156) — mathematically
  identical.
- SH knob: ``sh_degree=0`` mirrors --nosh (ref: src/app.cpp:335).
- sRGB knob: mirrors the FRAMEBUFFER_SRGB shader specialization
  (ref: shader/splat_vert.glsl:209-218).

Both pipelines run, forward and backward: the tiled one in every
instance-row layout (f32 rows, packed_colors, packed_feats16), with f32 or
bf16 accumulation and an f32 or bf16 gradient tail (both PROFILES run as the
JAX package defines them), and the global one (_composite_global), which
``pipeline="auto"`` picks below 4096 splats. ``supersample`` renders at a
multiple of the size and box-filters down; render_batch renders a [V]-batched
camera (a path, or Camera.stereo_pair's two eyes) one view after another.
sort_bands > 1, a TPU workaround, is not ported (ops/tiled.composite_tiled).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.utils.checkpoint

from splatapult_tpu_torch._device import DEFAULT_DEVICE, resolve_device
from splatapult_tpu_torch.core import transforms
from splatapult_tpu_torch.core.project import (
    ALPHA_CUTOFF,
    EXTENT_SIGMA,
    ProjectedSplats,
    project_gaussians,
    view_dirs,
)
from splatapult_tpu_torch.core.sh import eval_sh_radiance
from splatapult_tpu_torch.io.gaussians import GaussianScene
from splatapult_tpu_torch.ops.binning import TileGrid, instance_demand
from splatapult_tpu_torch.ops.tiled import composite_tiled


def _mat(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


@dataclasses.dataclass
class Camera:
    """Dynamic camera state.

    cam_to_world: [4, 4] GL-style camera matrix (-Z forward, +Y up), the
        reference's ``cameraMat``. The view matrix is its inverse.
    proj: [4, 4] GL-convention projection (see transforms.perspective /
        projection_from_tan_angles).
    A [V]-batched camera carries a leading axis on both fields.
    """

    cam_to_world: torch.Tensor
    proj: torch.Tensor

    @staticmethod
    def from_fov(cam_to_world, fovy: float, width: int, height: int,
                 near: float = 0.1, far: float = 1000.0,
                 device=DEFAULT_DEVICE) -> "Camera":
        """Default desktop camera: FOVY 45deg, near 0.1, far 1000
        (ref: src/app.cpp:73-75, src/sdl_main.cpp:72-73)."""
        device = resolve_device(device)
        proj = transforms.perspective(fovy, width / height, near, far)
        return Camera(cam_to_world=_mat(cam_to_world, device), proj=_mat(proj, device))

    def with_floor_transform(self, floor_mat) -> "Camera":
        """Compose a world/floor transform onto the camera, the way the VR
        carpet matrix multiplies the eye pose (ref: src/app.cpp:578)."""
        return Camera(
            cam_to_world=_mat(floor_mat, self.cam_to_world.device) @ self.cam_to_world,
            proj=self.proj,
        )

    @property
    def eye(self) -> torch.Tensor:
        return self.cam_to_world[..., :3, 3]

    def to(self, device) -> "Camera":
        return Camera(cam_to_world=self.cam_to_world.to(device),
                      proj=self.proj.to(device))

    def stereo_pair(self, ipd: float = 0.064, tan_angles=None,
                    near: float = 0.1, far: float = 1000.0) -> "Camera":
        """[2]-batched left/right eye cameras offset along the camera's +X
        axis by -ipd/2 and +ipd/2 — the batched analog of the reference's
        OpenXR stereo views (ref: src/xrbuddy.cpp:1689-1800). Render it with
        render_batch (one view after another).

        tan_angles: optional [2, 4] per-eye asymmetric frustum tangents
        (tan_left, tan_right, tan_up, tan_down — tan_left/tan_down negative
        for a frustum crossing the axis), the values an HMD runtime reports
        per eye (ref: src/xrbuddy.cpp:1802-1832 feeding util.cpp:412-480).
        Each eye then gets its own projection_from_tan_angles(near, far)
        projection; None duplicates this camera's proj. far <= near places
        the far plane at infinity. Both fields are on this camera's device."""
        c2w = self.cam_to_world
        offsets = torch.tensor([-ipd / 2.0, ipd / 2.0], dtype=torch.float32,
                               device=c2w.device)
        shift = torch.zeros((2, 4, 4), dtype=c2w.dtype, device=c2w.device)
        shift[:, :3, 3] = offsets[:, None] * c2w[:3, 0][None, :]
        mats = c2w[None] + shift
        if tan_angles is None:
            proj = torch.stack([self.proj, self.proj])
        else:
            ta = np.asarray(tan_angles, np.float32)
            if ta.shape != (2, 4):
                raise ValueError(
                    f"tan_angles must be [2, 4] (per-eye l, r, u, d), got {ta.shape}")
            proj = torch.stack([
                _mat(transforms.projection_from_tan_angles(
                    float(ta[e, 0]), float(ta[e, 1]), float(ta[e, 2]),
                    float(ta[e, 3]), near, far), c2w.device)
                for e in range(2)])
        return Camera(cam_to_world=mats, proj=proj)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render options (hashable). Same fields and defaults as the JAX
    package's RenderConfig, so a config carries across unchanged."""

    width: int = 1024  # default window 1024x768 (ref: src/sdl_main.cpp:72-73)
    height: int = 768
    sh_degree: Optional[int] = None  # None = use all stored coeffs; 0 = --nosh analog
    srgb_radiance_to_linear: bool = False  # FRAMEBUFFER_SRGB analog
    accum_dtype: str = "float32"  # "float32" | "bfloat16" (--fp32/--fp16 analog)
    pipeline: str = "auto"  # "auto" | "global" | "tiled"
    block_size: int = 64  # splats per composite scan step (global pipeline)
    # 1/256 discard threshold (ref: shader/splat_frag.glsl:38-41). It is a hard
    # discontinuity; set 0.0 for a fully smooth render.
    alpha_cutoff: float = ALPHA_CUTOFF
    # --- tiled pipeline knobs (ops/tiled.py) ---
    tile_size: int = 32  # pixels per tile side
    tile_block: int = 128  # instances per compositing block
    # instance-buffer capacity as a (possibly fractional) multiple of N; size
    # it from calibrate_config when the scene/camera are known, or leave the
    # generous default
    max_instance_mult: float = 6.0
    early_stop_eps: float = 0.0  # skip blocks once max transmittance < eps (0 = exact)
    # dtype per-instance gradients ride through the backward transpose sort
    # ("float32" | "bfloat16"); no effect on the forward
    grad_sort_dtype: str = "float32"
    # pack splat RGB as 16-bit fixed point (step 2^-12) in 32 B feature rows
    packed_colors: bool = False
    # ordered-grid supersampling factor: render at supersample^2 the pixel
    # count, box-filter down (the reference's USE_SUPERSAMPLING resolve,
    # ref: shader/desktop_frag.glsl:19-30)
    supersample: int = 1
    # viewer mode (the reference's only mode — it has no backward at all).
    # Attempting to differentiate a forward_only render raises.
    forward_only: bool = False
    # quantize whole instance feature rows to 16 B
    packed_feats16: bool = False
    # split the tiled pipeline into interleaved tile-row bands
    sort_bands: int = 1
    # depth precision in the instance sort key: 32 = exact f32 ordering
    # (default), 20 = top-20 f32 bits packed with the tile id into ONE sort
    # key (12 explicit mantissa bits, ~2.4e-4 relative depth; needs
    # num_tiles < 2048, else falls back to exact with a log line), 16 = the
    # coarser bf16 variant. Near-equal depths fall to the reference's
    # submission-order tie-break. See ops/binning.TileGrid.depth_bits.
    depth_bits: int = 32


# The two documented benchmark profiles. "exact" is the library default (exact
# f32 everywhere); "production" is the JAX package's training profile.
# packed_feats16 is intentionally NOT part of a profile: it is
# scale-conditional.
PROFILES = {
    "exact": dict(depth_bits=32, packed_colors=False, early_stop_eps=0.0,
                  grad_sort_dtype="float32"),
    "production": dict(depth_bits=20, packed_colors=True, early_stop_eps=1e-4,
                       grad_sort_dtype="bfloat16"),
}


def apply_profile(config: RenderConfig, profile: str) -> RenderConfig:
    """Overlay a named benchmark profile's precision knobs onto a config."""
    return dataclasses.replace(config, **PROFILES[profile])


def profile_name(config: RenderConfig) -> str:
    """Classify a config's precision knobs -> "exact" | "production" |
    "custom" (for tagging benchmark JSON output)."""
    for name, knobs in PROFILES.items():
        if all(getattr(config, k) == v for k, v in knobs.items()):
            return name
    return "custom"


class _PermuteRows(torch.autograd.Function):
    """Row permutation x[order] whose backward is the inverse gather
    g[inv_order]: the transpose of a permutation, where indexing's own
    backward would be a scatter-add."""

    @staticmethod
    def forward(ctx, x, order, inv_order):
        ctx.save_for_backward(inv_order)
        return x[order]

    @staticmethod
    def backward(ctx, g):
        (inv_order,) = ctx.saved_tensors
        return g[inv_order], None, None


def _front_to_back_order(depth: torch.Tensor, mask: torch.Tensor):
    """-> (order, inv_order): ascending depth, culled splats (+inf keys) at the
    end, equal keys by descending index — the order of the JAX package's
    ``lax.sort((key, -idx, idx), num_keys=2)``, as a stable sort of the
    reversed enumeration."""
    key = torch.where(mask, depth, torch.inf)
    n = key.shape[0]
    order = (n - 1) - torch.sort(key.flip(0), stable=True).indices
    inv_order = torch.empty_like(order)
    inv_order[order] = torch.arange(n, dtype=order.dtype, device=order.device)
    return order, inv_order


def prepare_splats(scene: GaussianScene, camera: Camera, config: RenderConfig,
                   sort: bool = True):
    """Shared front end: bake + project + SH -> dict of per-splat tensors.

    With ``sort=True`` (the default, as in the JAX package, and the global
    pipeline's form) they are sorted front-to-back with culled splats pushed
    to the back carrying zero alpha, in the JAX package's order bit for bit.
    With ``sort=False`` (the tiled pipeline's form) the tensors stay in scene
    order: ops/binning.bin_splats orders instances by a per-instance depth
    sort key instead.
    """
    means = scene.means
    cov3 = transforms.bake_covariance(scene.quats, scene.log_scales)
    alpha = torch.sigmoid(scene.opacities)  # ref: src/gaussiancloud.cpp:119-122

    view = transforms.invert_rigid(camera.cam_to_world)
    proj: ProjectedSplats = project_gaussians(
        means, cov3, view, camera.proj, (config.width, config.height)
    )

    rgb = eval_sh_radiance(scene.sh, view_dirs(means, camera.eye), config.sh_degree)
    if config.srgb_radiance_to_linear:
        rgb = transforms.srgb_to_linear(rgb)
    # zero masked splats' colors: a culled splat contributes nothing either
    # way, but a NaN radiance (e.g. a NaN position in a real-world capture
    # propagating through the SH view direction) must not reach a product
    # as 0 * NaN
    rgb = torch.where(proj.mask[:, None], rgb, 0.0)

    alpha_eff = torch.where(proj.mask, alpha, 0.0)
    extent = proj.extent
    if config.alpha_cutoff > 0.0:
        # Opacity-aware AABB tightening, exactly lossless: the composite
        # discards any pixel with alpha * exp(-q/2) <= cutoff (the reference's
        # 1/256 test, shader/splat_frag.glsl:38-41), i.e. q >= 2*ln(alpha /
        # cutoff). The binning rect therefore only needs to cover
        # k_eff = sqrt(2*ln(alpha/cutoff)) sigmas instead of the reference's
        # fixed 3.5 (shader/splat_geom.glsl:58) — low-opacity splats shrink,
        # and alpha <= cutoff splats generate zero tile instances.
        k2 = 2.0 * torch.log(
            torch.clamp_min(alpha_eff, 1e-37) * (1.0 / config.alpha_cutoff)
        )
        shrink = torch.sqrt(torch.clamp(k2, 0.0, EXTENT_SIGMA * EXTENT_SIGMA)) / EXTENT_SIGMA
        extent = extent * shrink.detach()[:, None]
    if not sort:
        return {
            "mean2d": proj.mean2d,
            "conic": proj.conic,
            "rgb": rgb,
            "alpha": alpha_eff,
            "depth": proj.depth.detach(),
            "radius": proj.radius.detach(),
            "extent": extent.detach(),
            "mask": proj.mask,
        }

    # Front-to-back order: ascending view depth; culled splats get +inf keys so
    # they land at the end (static-shape replacement for the reference's atomic
    # compaction, ref: shader/presort_compute.glsl:50-55). The reference's
    # stable radix sort draws equal-depth splats back-to-front in submission
    # order (ref: shader/presort_compute.glsl:52-53), so the front-to-back
    # order breaks ties by *descending* index.
    order, inv_order = _front_to_back_order(proj.depth.detach(), proj.mask)

    # ONE packed row permutation for every per-splat output: a single [N, 14]
    # gather and, backward, a single inverse gather
    packed = torch.cat(
        [proj.mean2d, proj.conic, rgb, alpha_eff[:, None],
         proj.depth.detach()[:, None], proj.radius.detach()[:, None],
         extent.detach(), proj.mask.to(torch.float32)[:, None]],
        dim=1,
    )  # [N, 14]
    packed_sorted = _PermuteRows.apply(packed, order, inv_order)
    return {
        "mean2d": packed_sorted[:, 0:2],
        "conic": packed_sorted[:, 2:5],
        "rgb": packed_sorted[:, 5:8],
        "alpha": packed_sorted[:, 8],
        "depth": packed_sorted[:, 9],
        "radius": packed_sorted[:, 10],
        "extent": packed_sorted[:, 11:13],
        "mask": packed_sorted[:, 13] > 0.5,
    }


def _global_block(color, trans, m2, cn, cb, ab, gx, gy, alpha_cutoff, dtype):
    """One block of the global composite: B splats front to back against every
    pixel, from the carry (colour [P, 3], T [P]) -> the carry after them."""
    dx = gx[None, :] - m2[:, 0:1]  # [B, P]
    dy = gy[None, :] - m2[:, 1:2]
    # g = exp(-0.5 d^T conic d) (ref: shader/splat_frag.glsl:20-25)
    q = cn[:, 0:1] * dx * dx + 2.0 * cn[:, 1:2] * dx * dy + cn[:, 2:3] * dy * dy
    wgt = ab[:, None] * torch.exp(-0.5 * q)
    if alpha_cutoff > 0.0:
        # shader/splat_frag.glsl:38-41
        wgt = torch.where(wgt > alpha_cutoff, wgt, 0.0)
    wgt = wgt.to(dtype)
    t_cum = torch.cumprod(1.0 - wgt, dim=0)  # transmittance after each splat in block
    t_before = torch.cat([torch.ones_like(t_cum[:1]), t_cum[:-1]], dim=0)
    eff = t_before * wgt  # [B, P] per-splat effective weight within block
    contrib = eff.t() @ cb.to(dtype)  # [P, 3]
    return color + trans[:, None] * contrib, trans * t_cum[-1]


def _composite_global(sorted_splats, config: RenderConfig) -> torch.Tensor:
    """Whole-image blockwise front-to-back composite -> [H, W, 4] f32.

    O(N * P): every splat is evaluated against every pixel, masked by the 1/256
    cutoff. Correct and differentiable for any scene; intended for small scenes
    and as the second-tier oracle for the tiled pipeline. The scan carry is
    (accumulated premultiplied RGB, transmittance) per pixel; within a block the
    front-to-back products are closed-form via cumprod, and the colour is a
    [P, B] x [B, 3] product. With accum_dtype="bfloat16" the weights are
    rounded to bf16 before the cumprod and the product and the carry are bf16,
    where the JAX package rounds. Plain PyTorch: the JAX package computes this
    in XLA, not in a Pallas kernel.
    """
    h, w = config.height, config.width
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[config.accum_dtype]
    b = config.block_size
    mean2d = sorted_splats["mean2d"]
    n = mean2d.shape[0]
    nb = -(-n // b)
    pad = nb * b - n

    def blocks(x):
        x = torch.nn.functional.pad(x, [0, 0] * (x.dim() - 1) + [0, pad])
        return x.reshape(nb, b, *x.shape[1:])

    dev = mean2d.device
    # gl_FragCoord-style pixel centers, row 0 = top of image
    px = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
    py = h - (torch.arange(h, dtype=torch.float32, device=dev) + 0.5)
    gx = px[None, :].expand(h, w).reshape(h * w)
    gy = py[:, None].expand(h, w).reshape(h * w)
    m2, cn, cb, ab = (blocks(sorted_splats[k]) for k in ("mean2d", "conic", "rgb", "alpha"))
    color = torch.zeros((h * w, 3), dtype=dtype, device=dev)
    trans = torch.ones((h * w,), dtype=dtype, device=dev)
    cutoff = float(config.alpha_cutoff)
    differentiated = torch.is_grad_enabled() and any(x.requires_grad for x in (m2, cn, cb, ab))
    for k in range(nb):
        args = (color, trans, m2[k], cn[k], cb[k], ab[k], gx, gy, cutoff, dtype)
        if differentiated:
            # the backward recomputes each block from the carry it started
            # from: only the carries ([nb, P, 4] in all) outlive the forward,
            # not every block's [B, P] temporaries (tens of GB at 1024x768
            # and a few thousand splats)
            color, trans = torch.utils.checkpoint.checkpoint(
                _global_block, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            color, trans = _global_block(*args)
    img = torch.cat([color, (1.0 - trans)[:, None]], dim=-1)
    return img.reshape(h, w, 4).to(torch.float32)


def resolve_pipeline(config: RenderConfig, num_splats: int) -> str:
    """The pipeline render runs: ``"auto"`` is global below 4096 splats and
    tiled from there up."""
    if config.pipeline == "auto":
        return "tiled" if num_splats >= 4096 else "global"
    return config.pipeline


def render(scene: GaussianScene, camera: Camera, config: RenderConfig) -> torch.Tensor:
    """Render one view -> [H, W, 4] premultiplied RGBA (row 0 = top), on the
    scene's device.

    The functional replacement for SplatRenderer::Sort + SplatRenderer::Render
    (ref: src/splatrenderer.cpp:153-343).
    """
    if config.supersample > 1:
        ss = config.supersample
        img = render(scene, camera, _rendered_config(config))
        # box-filter resolve (the reference averages the supersample grid,
        # ref: shader/desktop_frag.glsl:22-29)
        h, w = config.height, config.width
        return img.reshape(h, ss, w, ss, 4).mean(dim=(1, 3))
    pipeline = resolve_pipeline(config, scene.means.shape[0])
    if pipeline == "global":
        return _composite_global(prepare_splats(scene, camera, config, sort=True), config)
    if pipeline != "tiled":
        raise ValueError(f"unknown pipeline {config.pipeline!r}")
    # unsorted prepare: the binning sort carries the depth key instead
    return composite_tiled(prepare_splats(scene, camera, config, sort=False), config)


def _rendered_config(config: RenderConfig) -> RenderConfig:
    """The config of the image actually rendered: supersample x the width and
    height, supersample 1 (the config itself when supersample is 1)."""
    ss = config.supersample
    if ss <= 1:
        return config
    return dataclasses.replace(config, supersample=1, width=config.width * ss,
                               height=config.height * ss)


def render_batch(scene: GaussianScene, cameras: Camera, config: RenderConfig) -> torch.Tensor:
    """Render a [V]-batched camera -> [V, H, W, 4], one view after another.

    The batch analog of the reference's camera-path cycling (`n`/`p` keys,
    ref: src/app.cpp:650-674) and of its stereo two-view loop
    (ref: src/app.cpp:603-607). Each view is exactly ``render`` of that
    camera; autograd flows through the stack. The views are not batched into
    one call: the tiled pipeline's capacities are per view, and the JAX
    package measured its vmapped form slower than the sequential one.
    """
    return torch.stack([render(scene, Camera(cam_to_world=m, proj=p), config)
                        for m, p in zip(cameras.cam_to_world, cameras.proj)])


# Calibrated capacities quantize UP onto this geometric grid (x1.08 steps) so
# nearby cameras/demands resolve to the SAME RenderConfig, and therefore the
# same buffer sizes. Every capacity-proportional per-frame cost (sort, gather,
# kernel grids) pays the overshoot, which this pitch caps at 8%.
CAPACITY_BUCKET = 1.08


def bucket_capacity_mult(mult: float, bucket: float = CAPACITY_BUCKET) -> float:
    """Round a capacity multiplier UP to the geometric grid bucket**k."""
    if bucket <= 1.0 or mult <= 0.0:
        return mult
    k = math.ceil(math.log(mult) / math.log(bucket) - 1e-9)
    q = bucket ** k
    return q if q >= mult else bucket ** (k + 1)


def capacity_mult_for_demand(demand: int, num_splats: int,
                             config: RenderConfig, headroom: float = 1.06,
                             bucket: float = CAPACITY_BUCKET) -> float:
    """Demand -> max_instance_mult: headroom, geometric bucketing, and the
    power-of-two clamp of the JAX package.

    The clamp keeps mcap = emax + tiles*block under the next power of two
    whenever the demand itself fits below it. It is carried over unchanged so
    that both packages land on the same capacity for the same view; whether
    it helps torch.sort on a GPU has not been measured (ROADMAP)."""
    n = max(num_splats, 1)
    mult_needed = max(headroom * demand, 4096) / n
    mult = bucket_capacity_mult(mult_needed, bucket)
    # reconstruct the emax/mcap geometry TileGrid.create derives from mult
    tiles = ((-(-config.width // config.tile_size))
             * (-(-config.height // config.tile_size)))
    pad_cap = tiles * config.tile_block // max(config.sort_bands, 1)
    emax_needed = max(4096, -(-int(mult_needed * n) // 4096) * 4096)
    cliff = 1 << math.ceil(math.log2(emax_needed + pad_cap))
    emax_cap = (cliff - pad_cap) // 4096 * 4096
    emax = max(4096, -(-int(mult * n) // 4096) * 4096)
    if emax > emax_cap >= emax_needed:
        mult = emax_cap / n
    return mult


def calibrate_config(scene: GaussianScene, cameras: Camera,
                     config: RenderConfig, headroom: float = 1.06,
                     bucket: float = CAPACITY_BUCKET) -> RenderConfig:
    """Right-size the tiled pipeline's instance capacity for known view(s).

    Measures the true tile-instance demand of each camera (one cheap pre-pass;
    ops.binning.instance_demand) and returns a config whose
    ``max_instance_mult`` fits the peak demand plus ``headroom`` — every
    per-frame sort/gather/kernel then runs at measured rather than worst-case
    capacity (the analog of the reference's radix-workgroup auto-tuner,
    ref: src/app.cpp:843-874). Re-calibrate when the camera moves enough to
    change the demand materially; overflow is always counted, never silent,
    so a stale calibration degrades visibly rather than incorrectly.

    cameras: a single Camera or a [V]-batched one (leading axis on both
    fields); the peak demand across views is used. This is the one place that
    reads a scalar back from the device, by contract.

    The returned ``max_instance_mult`` is rounded UP onto the geometric
    ``bucket`` grid (see bucket_capacity_mult) so nearby demands produce an
    IDENTICAL config; pass bucket=1.0 for the exact (continuous) calibration.

    With ``supersample > 1`` the demand and the capacity are those of the
    rendered image, supersample x the width and height: render draws at that
    size with this config's ``max_instance_mult``. (The JAX package sizes it
    at the output size, so its calibrated supersampled renders drop
    instances; ROADMAP queue 3.)
    """
    if config.sort_bands > 1:
        raise NotImplementedError(
            "sort_bands > 1 is not ported (ROADMAP queue 1 item 16)")
    rendered = _rendered_config(config)
    n = scene.means.shape[0]
    grid = TileGrid.create(width=rendered.width, height=rendered.height,
                           num_splats=n, tile_size=rendered.tile_size)

    def demand_of(cam: Camera) -> torch.Tensor:
        d = prepare_splats(scene, cam, rendered, sort=False)
        return instance_demand(d["mean2d"], d["extent"], grid)

    if cameras.cam_to_world.ndim == 2:
        peak = demand_of(cameras)
    else:
        peak = torch.stack([
            demand_of(Camera(cam_to_world=m, proj=p))
            for m, p in zip(cameras.cam_to_world, cameras.proj)
        ]).max()
    mult = capacity_mult_for_demand(int(peak.item()), n, rendered, headroom, bucket)
    return dataclasses.replace(config, max_instance_mult=mult)
