"""Plain PyTorch reference of a 3D-Gaussian-splat frame: projection, SH
radiance, tile binning and front-to-back compositing with the 1/256 discard.

It follows the published description (Kerbl et al., "3D Gaussian Splatting
for Real-Time Radiance Field Rendering", SIGGRAPH 2023; the EWA splatting of
Zwicker et al. 2001) and the configuration's stated knobs, and imports nothing
of the program under test. It runs in float64 by default, on whatever device
its inputs are on, tile chunk by tile chunk so that it fits.

The configuration states (and this file follows):
- culling: view depth > 0, |ndc x|, |ndc y| < 1.5 and <= 2, ndc z >= 0.25,
  and a 2D covariance with a positive determinant;
- the 2D covariance is J W S W^T J^T plus 0.3 px on its diagonal;
- a splat covers the tiles its axis-aligned 3.5-sigma box touches, the box
  shrunk to sqrt(2 ln(alpha / cutoff)) sigma (pixels outside it fall under
  the discard);
- each tile's splats are taken in ascending order of the depth key (the
  float32 depth's bits, or their top 20 bits), equal keys by descending splat
  index, in blocks of ``tile_block``;
- a pixel's weight is alpha * exp(-q / 2), dropped at or below the cutoff;
  colour and transmittance are composited front to back;
- with ``early_stop_eps`` > 0 a tile stops before block r > 0 once every one
  of its pixels has a transmittance below eps;
- with ``colour_step`` > 0 the colours are rounded to that step (half to
  even, 16-bit range) on the way into the composite, and the gradient passes
  the rounding unchanged.
"""

from __future__ import annotations

import dataclasses

import torch

EXTENT_SIGMA = 3.5
COV2D_DILATION = 0.3
CHUNK_INSTANCES = 1 << 16  # instances a tile chunk aims at (a deeper tile is a chunk alone)

_SH = (0.28209479177387814, 0.4886025119029199, 1.0925484305920792, 0.31539156525252005,
       0.5462742152960396, 0.5900435899266435, 2.8906114426405543, 0.4570457994644658,
       0.37317633259011546, 1.4453057213202771)


@dataclasses.dataclass(frozen=True)
class RefConfig:
    width: int
    height: int
    tile_size: int = 32
    tile_block: int = 128
    alpha_cutoff: float = 1.0 / 256.0
    early_stop_eps: float = 0.0
    depth_bits: int = 32
    colour_step: float = 0.0

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile_size)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile_size)

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y


def ref_config(config: dict) -> RefConfig:
    """A configuration file's dict -> RefConfig (colour_step from packed_colors)."""
    return RefConfig(
        width=config["width"], height=config["height"], tile_size=config["tile_size"],
        tile_block=config["tile_block"], alpha_cutoff=config["alpha_cutoff"],
        early_stop_eps=config["early_stop_eps"], depth_bits=config["depth_bits"],
        colour_step=2.0 ** -12 if config["packed_colors"] else 0.0)


def _sh_basis(d):
    """Real SH basis to degree 3 of unit directions [N, 3] -> [N, 16]."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    x2, y2, z2 = x * x, y * y, z * z
    k = _SH
    one = torch.ones_like(x)
    return torch.stack([
        k[0] * one, -k[1] * y, k[1] * z, -k[1] * x,
        k[2] * y * x, -k[2] * y * z, k[3] * (3 * z2 - 1), -k[2] * x * z, k[4] * (x2 - y2),
        -k[5] * y * (3 * x2 - y2), k[6] * y * x * z, -k[7] * y * (5 * z2 - 1),
        k[8] * z * (5 * z2 - 3), -k[7] * x * (5 * z2 - 1), k[9] * z * (x2 - y2),
        -k[5] * x * (x2 - 3 * y2)], dim=1)


def project(params: dict, cam_to_world, proj, cfg: RefConfig, dtype=torch.float64) -> dict:
    """Scene parameters (dict of means [N,3], sh [N,3,16], opacities [N],
    log_scales [N,3], quats [N,4]) -> per-splat screen quantities in ``dtype``,
    differentiable in the parameters: mean2d [N,2] (+y up), conic [N,3]
    (A, B, C of the inverse 2D covariance), rgb [N,3], alpha [N] (0 if
    culled), depth [N] float32 (the sort's depth), rect [N,4] int64 (x0, r0,
    nx, ny in tiles; nx * ny = 0 covers nothing)."""
    means = params["means"].to(dtype)
    n = means.shape[0]
    c2w = torch.as_tensor(cam_to_world, dtype=dtype, device=means.device)
    pm = torch.as_tensor(proj, dtype=dtype, device=means.device)
    view = torch.linalg.inv(c2w)
    w_, h_ = float(cfg.width), float(cfg.height)

    q = params["quats"].to(dtype)
    q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    w, x, y, z = q.unbind(1)
    rot = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], 1).reshape(n, 3, 3)
    s2 = torch.exp(2 * params["log_scales"].to(dtype))
    cov3 = (rot * s2[:, None, :]) @ rot.transpose(1, 2)

    t = means @ view[:3, :3].T + view[:3, 3]
    clip = t @ pm[:, :3].T + pm[:, 3]
    wc = clip[:, 3]
    safe_wc = torch.where(wc.abs() < 1e-300, 1e-300, wc)
    ndc = clip[:, :3] / safe_wc[:, None]
    mean2d = torch.stack([0.5 * (w_ + ndc[:, 0] * w_), 0.5 * (h_ + ndc[:, 1] * h_)], 1)
    in_view = ((wc > 0) & (ndc[:, 0].abs() < 1.5) & (ndc[:, 1].abs() < 1.5)
               & (ndc[:, 2] >= 0.25) & (ndc[:, 0].abs() <= 2.0) & (ndc[:, 1].abs() <= 2.0))

    # EWA Jacobian at t; splats out of view take the point one unit ahead so
    # that nothing infinite reaches a gradient
    tx = torch.where(in_view, t[:, 0], 0.0)
    ty = torch.where(in_view, t[:, 1], 0.0)
    tz = torch.where(in_view, t[:, 2], -1.0)
    sx, sy = pm[0, 0], pm[1, 1]
    zero = torch.zeros_like(tz)
    jac = torch.stack([-(sx * w_) / (2 * tz), zero, (sx * w_) * tx / (2 * tz * tz),
                       zero, -(sy * h_) / (2 * tz), (sy * h_) * ty / (2 * tz * tz)],
                      1).reshape(n, 2, 3)
    jw = jac @ view[:3, :3]
    cov2 = jw @ cov3 @ jw.transpose(1, 2)
    a = cov2[:, 0, 0] + COV2D_DILATION
    b = cov2[:, 0, 1]
    c = cov2[:, 1, 1] + COV2D_DILATION
    det = a * c - b * b
    visible = in_view & (det > 0)
    safe_det = torch.where(visible, det, 1.0)
    conic = torch.stack([c / safe_det, -b / safe_det, a / safe_det], 1)

    eye = c2w[:3, 3]
    d = means - eye
    d = d / torch.clamp_min(torch.linalg.vector_norm(d, dim=1, keepdim=True), 1e-300)
    sh = params["sh"].to(dtype)
    rgb = 0.5 + (sh * _sh_basis(d)[:, None, :sh.shape[2]]).sum(2)
    rgb = torch.where(visible[:, None], rgb, 0.0)
    alpha = torch.where(visible, torch.sigmoid(params["opacities"].to(dtype)), 0.0)

    with torch.no_grad():
        k2 = 2.0 * torch.log(torch.clamp_min(alpha, 1e-300) / cfg.alpha_cutoff)
        shrink = torch.sqrt(torch.clamp(k2, 0.0, EXTENT_SIGMA ** 2)) / EXTENT_SIGMA
        rx = EXTENT_SIGMA * torch.sqrt(torch.clamp_min(a, 0.0)) * shrink
        ry = EXTENT_SIGMA * torch.sqrt(torch.clamp_min(c, 0.0)) * shrink
        ok = visible & (rx > 0) & (ry > 0)
        ts = cfg.tile_size
        mx, my = mean2d[:, 0], mean2d[:, 1]
        x0 = torch.clamp(torch.floor((mx - rx) / ts), 0, cfg.tiles_x)
        x1 = torch.clamp(torch.ceil((mx + rx) / ts), 0, cfg.tiles_x)
        r0 = torch.clamp(torch.floor((h_ - my - ry) / ts), 0, cfg.tiles_y)
        r1 = torch.clamp(torch.ceil((h_ - my + ry) / ts), 0, cfg.tiles_y)
        nx = torch.where(ok, x1 - x0, 0.0)
        ny = torch.where(ok, r1 - r0, 0.0)
        rect = torch.stack([x0, r0, nx, ny], 1).to(torch.int64)
    return {"mean2d": mean2d, "conic": conic, "rgb": rgb, "alpha": alpha,
            "depth": torch.clamp_min(wc.detach(), 0.0).to(torch.float32), "rect": rect}


def bin_instances(sp: dict, cfg: RefConfig) -> dict:
    """(splat, tile) instances in compositing order -> splat [M], tile [M],
    rank [M] (position in its tile's list), tile_count [T]."""
    rect = sp["rect"]
    dev = rect.device
    x0, r0, nx, ny = rect.unbind(1)
    cnt = nx * ny
    m = int(cnt.sum())
    splat = torch.repeat_interleave(torch.arange(cnt.shape[0], device=dev), cnt)
    start = torch.cumsum(cnt, 0) - cnt
    j = torch.arange(m, device=dev) - start[splat]
    w = nx[splat]
    tile = (r0[splat] + torch.div(j, w, rounding_mode="floor")) * cfg.tiles_x + x0[splat] + j % w
    bits = sp["depth"].contiguous().view(torch.int32).to(torch.int64)
    if cfg.depth_bits == 20:
        key = (tile << 20) | ((bits[splat] >> 11) & 0xFFFFF)
    elif cfg.depth_bits == 32:
        key = (tile << 32) | bits[splat]
    else:
        raise ValueError(f"depth_bits {cfg.depth_bits}")
    # descending splat index first, then a stable sort by (tile, depth key)
    splat, tile, key = splat.flip(0), tile.flip(0), key.flip(0)
    order = torch.sort(key, stable=True).indices
    splat, tile = splat[order], tile[order]
    tile_count = torch.bincount(tile, minlength=cfg.num_tiles)
    tile_start = torch.cumsum(tile_count, 0) - tile_count
    rank = torch.arange(m, device=dev) - tile_start[tile]
    return {"splat": splat, "tile": tile, "rank": rank, "tile_count": tile_count}


def _chunks(tile_count: torch.Tensor, budget: int, max_tiles: int = 128):
    """Consecutive tile ranges -> [(t0, t1, s0, s1)] of about ``budget``
    instances and at most ``max_tiles`` tiles each (instance ranges [s0, s1)
    in the sorted order)."""
    counts = tile_count.tolist()
    out, t0, s0, acc = [], 0, 0, 0
    for t, c in enumerate(counts):
        if acc and (acc + c > budget or t - t0 >= max_tiles):
            out.append((t0, t, s0, s0 + acc))
            t0, s0, acc = t, s0 + acc, 0
        acc += c
    if acc:
        out.append((t0, len(counts), s0, s0 + acc))
    return out


def _chunk_walk(f: dict, inst: dict, s0: int, s1: int, t0: int, t1: int,
                cfg: RefConfig, want_image: bool):
    """Composite the instances [s0, s1) of tiles [t0, t1), whose features
    ``f`` (mean2d, conic, alpha, rgb) are given per instance -> (tile rows
    [t1 - t0, P, 4] or None, the pairs above the discard that the walk
    reaches, the instances it reaches).

    Arrays are [pixel, instance], so that the running sums down the lists
    run along the contiguous axis. A pixel p = v * tile_size + u of the tile
    whose top-left pixel is (tx, ty) sits at (tx + u + 1/2, H - ty - v - 1/2)
    (+y up), and q = C dy_v^2 + A dx_u^2 + 2 B dy_v dx_u. Transmittance is exp
    of the running sum of log(1 - w) down each tile's list; a tile's colour
    and log-transmittance are sums over its instances, taken as products
    with the chunk's [instance, tile] membership matrix."""
    tile = inst["tile"][s0:s1]
    rank = inst["rank"][s0:s1]
    mean2d, conic, alpha = f["mean2d"], f["conic"], f["alpha"]
    dtype, dev = mean2d.dtype, mean2d.device
    ts, m, p = cfg.tile_size, s1 - s0, cfg.tile_size * cfg.tile_size
    off = torch.arange(ts, dtype=dtype, device=dev)[:, None] + 0.5
    tx = (tile % cfg.tiles_x).to(dtype) * ts
    ty = torch.div(tile, cfg.tiles_x, rounding_mode="floor").to(dtype) * ts
    dx = (tx - mean2d[:, 0])[None, :] + off  # [u, m]
    dy = (cfg.height - ty - mean2d[:, 1])[None, :] - off  # [v, m]
    q = torch.addcmul((conic[:, 2] * dy * dy)[:, None, :] + (conic[:, 0] * dx * dx)[None, :, :],
                      (2.0 * conic[:, 1] * dy)[:, None, :], dx[None, :, :]).reshape(p, m)
    log_w = torch.add(torch.log(torch.clamp_min(alpha, 1e-300))[None, :], q, alpha=-0.5)
    above = log_w > torch.log(torch.tensor(cfg.alpha_cutoff, dtype=dtype, device=dev))
    if cfg.early_stop_eps <= 0.0 and not want_image:
        return None, int(above.sum()), m
    local = tile - t0
    nt = t1 - t0
    counts = inst["tile_count"][t0:t1]
    first = torch.cumsum(counts, 0) - counts  # each tile's first instance in the chunk
    wt = torch.where(above, torch.exp(log_w), 0.0)
    lg = torch.log1p(-torch.clamp_max(wt, 1.0 - 2.0 ** -40))
    cum = torch.cumsum(lg, 1)
    excl = cum - lg
    base = cum[:, torch.clamp_min(first - 1, 0)] * (first > 0).to(dtype)  # [P, nt]
    keep = None
    if cfg.early_stop_eps > 0.0:
        with torch.no_grad():
            at = torch.nonzero((rank % cfg.tile_block == 0) & (rank > 0)).flatten()
            t_at = torch.exp(excl[:, at] - base[:, local[at]]).amax(0)
            vote = at[t_at < cfg.early_stop_eps]
            cut = torch.full((nt,), 2 ** 62, dtype=torch.int64, device=dev)
            cut = cut.scatter_reduce(0, local[vote], rank[vote], "amin")
            keep = rank < cut[local]
            above = above & keep[None, :]
    with torch.no_grad():
        pairs = int(above.sum())
        walked = m if keep is None else int(keep.sum())
    if not want_image:
        return None, pairs, walked
    member = torch.zeros((m, nt), dtype=dtype, device=dev)
    member[torch.arange(m, device=dev), local] = 1.0 if keep is None else keep.to(dtype)
    eff = torch.exp(excl - base[:, local]) * wt  # [P, m]
    colour = eff @ (member[:, None, :] * f["rgb"][:, :, None]).reshape(m, 3 * nt)  # [P, 3 nt]
    log_t = lg @ member  # [P, nt]
    rows = torch.cat([colour.reshape(p, 3, nt).permute(2, 0, 1),
                      (1.0 - torch.exp(log_t)).T[:, :, None]], 2)
    return rows, pairs, walked


_FEATS = ("mean2d", "conic", "alpha", "rgb")


def _gather(feats: dict, inst: dict, s0: int, s1: int) -> dict:
    splat = inst["splat"][s0:s1]
    return {k: feats[k][splat] for k in _FEATS}


def composite_features(sp: dict, cfg: RefConfig) -> dict:
    """The features the composite reads: colours rounded to ``colour_step``
    with the gradient passed through unchanged."""
    rgb = sp["rgb"]
    if cfg.colour_step > 0.0:
        qc = torch.clamp(torch.round(rgb / cfg.colour_step), -32768, 32767) * cfg.colour_step
        rgb = rgb + (qc - rgb).detach()
    return {"mean2d": sp["mean2d"], "conic": sp["conic"], "alpha": sp["alpha"], "rgb": rgb}


def tiles_to_image(tiles: torch.Tensor, cfg: RefConfig) -> torch.Tensor:
    """[T, P, 4] tile rows -> [H, W, 4] image, row 0 at the top."""
    ts = cfg.tile_size
    img = (tiles.reshape(cfg.tiles_y, cfg.tiles_x, ts, ts, 4).permute(0, 2, 1, 3, 4)
           .reshape(cfg.tiles_y * ts, cfg.tiles_x * ts, 4))
    return img[:cfg.height, :cfg.width]


def image_to_tiles(img: torch.Tensor, cfg: RefConfig) -> torch.Tensor:
    """[H, W, C] image -> [T, P, C] tile rows (pixels past the image are 0)."""
    ts = cfg.tile_size
    h, w = cfg.tiles_y * ts, cfg.tiles_x * ts
    pad = torch.zeros((h, w, img.shape[2]), dtype=img.dtype, device=img.device)
    pad[:cfg.height, :cfg.width] = img
    return (pad.reshape(cfg.tiles_y, ts, cfg.tiles_x, ts, -1).permute(0, 2, 1, 3, 4)
            .reshape(cfg.num_tiles, ts * ts, -1))


def render(params: dict, cam_to_world, proj, cfg: RefConfig, dtype=torch.float64,
           budget: int = CHUNK_INSTANCES) -> torch.Tensor:
    """The reference image [H, W, 4] (premultiplied RGBA, row 0 at the top)."""
    with torch.no_grad():
        sp = project(params, cam_to_world, proj, cfg, dtype)
        inst = bin_instances(sp, cfg)
        feats = composite_features(sp, cfg)
        p = cfg.tile_size * cfg.tile_size
        tiles = torch.zeros((cfg.num_tiles, p, 4), dtype=dtype, device=sp["mean2d"].device)
        for t0, t1, s0, s1 in _chunks(inst["tile_count"], budget):
            tiles[t0:t1] = _chunk_walk(_gather(feats, inst, s0, s1), inst, s0, s1, t0, t1,
                                       cfg, True)[0]
        return tiles_to_image(tiles, cfg)


def work_counts(params: dict, cam_to_world, proj, cfg: RefConfig,
                budget: int = CHUNK_INSTANCES) -> dict:
    """What any implementation of this frame must work on -> {"pairs": the
    (instance, pixel) pairs above the discard up to where the walk stops,
    "instances": (splat, tile) instances the walk reaches, "splats": splats
    the frame covers, "pixels": the image's pixels, "scene_splats": N}.
    Counted in float32 without an early stop, in float64 with one (the stop
    needs the transmittance)."""
    dtype = torch.float64 if cfg.early_stop_eps > 0.0 else torch.float32
    with torch.no_grad():
        sp = project(params, cam_to_world, proj, cfg, dtype)
        inst = bin_instances(sp, cfg)
        feats = composite_features(sp, cfg)
        pairs = walked = 0
        for t0, t1, s0, s1 in _chunks(inst["tile_count"], budget):
            _, pr, wk = _chunk_walk(_gather(feats, inst, s0, s1), inst, s0, s1, t0, t1,
                                    cfg, False)
            pairs += pr
            walked += wk
        covered = int(((sp["rect"][:, 2] * sp["rect"][:, 3]) > 0).sum())
    return {"pairs": pairs, "instances": walked, "splats": covered,
            "pixels": cfg.width * cfg.height, "scene_splats": int(params["means"].shape[0])}


def loss_and_grads(params: dict, cam_to_world, proj, target, cfg: RefConfig,
                   dtype=torch.float64, budget: int = CHUNK_INSTANCES):
    """Mean squared error of the reference image against ``target`` [H, W, 4]
    -> (loss as a float, {leaf: gradient} in ``dtype``), the composite's
    gradient taken tile chunk by tile chunk."""
    leaves = {k: v.detach().to(dtype).requires_grad_(True) for k, v in params.items()}
    sp = project(leaves, cam_to_world, proj, cfg, dtype)
    inst = bin_instances(sp, cfg)
    feats = composite_features(sp, cfg)
    flat = {k: feats[k].detach() for k in _FEATS}
    acc = {k: torch.zeros_like(flat[k]) for k in _FEATS}
    tgt = image_to_tiles(target.to(dtype), cfg)
    inside = image_to_tiles(torch.ones((cfg.height, cfg.width, 1), dtype=dtype,
                                       device=tgt.device), cfg)
    scale = 1.0 / (cfg.width * cfg.height * 4)
    # tiles no instance reaches render (0, 0, 0, 0)
    sse = float(((tgt * inside) ** 2).sum())
    for t0, t1, s0, s1 in _chunks(inst["tile_count"], budget):
        f = {k: x.requires_grad_(True) for k, x in _gather(flat, inst, s0, s1).items()}
        rows = _chunk_walk(f, inst, s0, s1, t0, t1, cfg, True)[0]
        part = (((rows - tgt[t0:t1]) * inside[t0:t1]) ** 2).sum()
        sse += float(part.detach()) - float(((tgt[t0:t1] * inside[t0:t1]) ** 2).sum())
        (part * scale).backward()
        splat = inst["splat"][s0:s1]
        for k in _FEATS:
            acc[k].index_add_(0, splat, f[k].grad)
    torch.autograd.backward([feats[k] for k in _FEATS], [acc[k] for k in _FEATS])
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v)) for k, v in leaves.items()}
    return sse * scale, grads


def adam_update(params: dict, grads: dict, state: dict, step: int, lr: dict,
                betas=(0.9, 0.999), eps: float = 1e-8) -> None:
    """One Adam step (Kingma and Ba 2015, with bias correction) on the dict of
    tensors ``params`` in place; ``state`` holds the moments."""
    b1, b2 = betas
    for k, p in params.items():
        g = grads[k].to(p.dtype)
        m, v = state.setdefault(k, (torch.zeros_like(p), torch.zeros_like(p)))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        m_hat = m / (1 - b1 ** step)
        v_hat = v / (1 - b2 ** step)
        p.sub_(lr[k] * m_hat / (torch.sqrt(v_hat) + eps))
