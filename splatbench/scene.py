"""The garden stand-in, made on the device from a seed.

A synthetic scene, not a trained one: a frozen copy of the layout and
statistics of the port's ``io/synth.make_garden_scene``, a procedural
stand-in shaped after the Mip-NeRF 360 "garden" capture (a ground disk
densified around the capture orbit, a round table, a plant, shrub clusters
and a distant background shell; surfel anisotropy, scale tracking the local
spacing, a footprint clamp of 0.5-8 px sigma from the orbit, bimodal
opacities, SH energy decaying as 1/(1 + l)). These statistics are the
generator's own choices, not measured on a trained scene. Rewritten in torch
so that it runs on the card in a few large calls. Its draws are torch's, so it does not repeat the numpy version's
numbers; it repeats its own for a seed on a device.
"""

from __future__ import annotations

import math

import torch

SH_C0 = 0.28209479177387814
FRACTIONS = {"ground": 0.42, "table": 0.08, "plant": 0.10, "shrubs": 0.22, "background": 0.18}
FIELDS = ("means", "sh", "opacities", "log_scales", "quats")
FOCAL = 1080.0 / (2.0 * math.tan(math.pi / 8.0))  # the orbit's 1080-row, 45-degree view
LAYOUT_SEED = 0


class _Draw:
    """Seeded draws on one device."""

    def __init__(self, seed: int, device):
        self.g = torch.Generator(device=device)
        self.g.manual_seed(int(seed) % (1 << 63))
        self.device = device

    def uniform(self, lo, hi, *shape):
        return torch.rand(shape, generator=self.g, device=self.device) * (hi - lo) + lo

    def normal(self, mu, sigma, *shape):
        return torch.randn(shape, generator=self.g, device=self.device) * sigma + mu

    def integers(self, hi, n):
        return torch.randint(0, hi, (n,), generator=self.g, device=self.device)

    def permutation(self, n):
        return torch.randperm(n, generator=self.g, device=self.device)


def _unit(v):
    return v / torch.clamp_min(torch.linalg.vector_norm(v, dim=-1, keepdim=True), 1e-12)


def _quat_align_z(normals, draw):
    """Quaternions (w, x, y, z) taking +Z onto the normals, rolled at random
    about them."""
    n = normals.shape[0]
    nrm = _unit(normals)
    axis = torch.stack([-nrm[:, 1], nrm[:, 0], torch.zeros_like(nrm[:, 0])], 1)  # z x n
    s = torch.linalg.vector_norm(axis, dim=1)
    c = nrm[:, 2]
    fallback = torch.tensor([1.0, 0.0, 0.0], device=normals.device)
    axis = torch.where(s[:, None] > 1e-6, axis / torch.clamp_min(s[:, None], 1e-12), fallback)
    half = 0.5 * torch.atan2(s, c)
    w1, (x1, y1, z1) = torch.cos(half), (torch.sin(half)[:, None] * axis).unbind(1)
    phi = draw.uniform(0.0, math.pi, n)
    w2, z2 = torch.cos(phi), torch.sin(phi)
    return torch.stack([w1 * w2 - z1 * z2, x1 * w2 + y1 * z2, y1 * w2 - x1 * z2,
                        w1 * z2 + z1 * w2], 1)


def _component(draw, n, pos, normals, albedo, jitter, spacing, surfel, spread=0.45):
    base = torch.log(torch.clamp_min(torch.as_tensor(spacing, device=pos.device), 1e-5))
    tangent = base + draw.normal(0.0, spread, n)
    if surfel:
        log_scales = torch.stack([tangent, tangent + draw.normal(0.0, 0.2, n),
                                  tangent + math.log(0.25)], 1)
        quats = _quat_align_z(normals, draw)
    else:
        log_scales = tangent[:, None] + draw.normal(0.0, 0.25, n, 3)
        quats = _unit(draw.normal(0.0, 1.0, n, 4))
    alb = torch.as_tensor(albedo, dtype=torch.float32, device=pos.device)
    colour = torch.clamp(alb * (1.0 + draw.normal(0.0, jitter, n, 3)), 0.0, 1.0)
    return pos, log_scales, quats, colour


def make_scene(num_splats: int, seed: int, device) -> dict:
    """The garden stand-in of ``num_splats`` splats at SH degree 3 -> dict of
    float32 tensors (means [N,3], sh [N,3,16], opacities [N], log_scales
    [N,3], quats [N,4]) on ``device``."""
    d = _Draw(seed, device)
    counts = {k: int(num_splats * f) for k, f in FRACTIONS.items()}
    counts["ground"] += num_splats - sum(counts.values())
    parts = []

    n = counts["ground"]
    n_band = int(0.6 * n)
    r = torch.cat([torch.clamp(d.normal(3.0, 2.2, n_band).abs(), 0.0, 12.0),
                   12.0 * torch.sqrt(d.uniform(0.0, 1.0, n - n_band))])
    th = d.uniform(0.0, 2 * math.pi, n)
    pos = torch.stack([r * torch.cos(th), d.normal(0.0, 0.02, n) + 0.03 * torch.sin(3 * th) * r / 12,
                       r * torch.sin(th)], 1)
    nrm = torch.tensor([0.0, 1.0, 0.0], device=device).expand(n, 3)
    p_band = (torch.exp(-0.5 * ((r - 3.0) / 2.2) ** 2) + torch.exp(-0.5 * ((r + 3.0) / 2.2) ** 2)
              ) / (2.2 * math.sqrt(2 * math.pi))
    p_r = 0.6 * p_band + 0.4 * (2.0 * r / 144.0)
    density = torch.clamp_min(n * p_r / torch.clamp_min(2 * math.pi * r, 0.5), 1.0)
    parts.append(_component(d, n, pos, nrm, [0.22, 0.32, 0.12], 0.35,
                            1.8 / torch.sqrt(density), surfel=True))

    n = counts["table"]
    u, v = d.uniform(0.0, 2 * math.pi, n), d.uniform(0.0, 2 * math.pi, n)
    rm, rt = 0.55, 0.16
    pos = torch.stack([(rm + rt * torch.cos(v)) * torch.cos(u), 0.75 + rt * torch.sin(v),
                       (rm + rt * torch.cos(v)) * torch.sin(u)], 1)
    nrm = torch.stack([torch.cos(v) * torch.cos(u), torch.sin(v), torch.cos(v) * torch.sin(u)], 1)
    parts.append(_component(d, n, pos, nrm, [0.55, 0.48, 0.40], 0.15,
                            1.8 * math.sqrt(4 * math.pi ** 2 * rm * rt / max(n, 1)), surfel=True))

    n = counts["plant"]
    dirs = _unit(d.normal(0.0, 1.0, n, 3)) * d.uniform(0.25, 1.0, n, 1) ** (1 / 3)
    pos = dirs * torch.tensor([0.35, 0.45, 0.35], device=device) + torch.tensor(
        [0.0, 1.35, 0.0], device=device)
    spacing = (4 / 3 * math.pi * 0.35 * 0.45 * 0.35 / max(n, 1)) ** (1 / 3)
    parts.append(_component(d, n, pos, dirs, [0.15, 0.38, 0.10], 0.45, 1.8 * spacing,
                            surfel=False))

    # the shrub clusters are the garden's layout, the same for every seed: a
    # seed draws the splats, not where the shrubs stand (their placement would
    # move the close views' demand, and with it the capacity, from seed to seed)
    n = counts["shrubs"]
    k = 14
    lay = _Draw(LAYOUT_SEED, torch.device("cpu"))
    cth, cr = lay.uniform(0.0, 2 * math.pi, k), lay.uniform(6.0, 11.0, k)
    centers = torch.stack([cr * torch.cos(cth), lay.uniform(0.4, 1.4, k), cr * torch.sin(cth)],
                          1).to(device)
    sizes = lay.uniform(0.5, 1.6, k).to(device)
    which = d.integers(k, n)
    pos = centers[which] + d.normal(0.0, 1.0, n, 3) * sizes[which, None] * torch.tensor(
        [1.0, 0.8, 1.0], device=device)
    pos = torch.stack([pos[:, 0], pos[:, 1].abs() + 0.05, pos[:, 2]], 1)
    spacing = (float((4 / 3 * math.pi * sizes ** 3 * 0.8).sum()) / max(n, 1)) ** (1 / 3)
    parts.append(_component(d, n, pos, _unit(pos - centers[which]), [0.18, 0.30, 0.12], 0.40,
                            1.6 * spacing, surfel=False))

    n = counts["background"]
    th, rr = d.uniform(0.0, 2 * math.pi, n), d.uniform(15.0, 25.0, n)
    y = d.uniform(0.0, 12.0, n) * (0.3 + 0.7 * d.uniform(0.0, 1.0, n))
    pos = torch.stack([rr * torch.cos(th), y, rr * torch.sin(th)], 1)
    nrm = -torch.stack([torch.cos(th), torch.zeros_like(th), torch.sin(th)], 1)
    spacing = math.sqrt(2 * math.pi * 20.0 * 12.0 / max(n, 1))
    sky = d.uniform(0.0, 1.0, n) < 0.25
    p, ls, q, _ = _component(d, n, pos, nrm, [1.0, 1.0, 1.0], 0.0, 1.6 * spacing, surfel=True)
    albedo = torch.where(sky[:, None], torch.tensor([0.55, 0.65, 0.85], device=device),
                         torch.tensor([0.25, 0.30, 0.22], device=device))
    parts.append((p, ls, q, torch.clamp(albedo * (1.0 + d.normal(0.0, 0.25, n, 3)), 0, 1)))

    means, log_scales, quats, colours = (torch.cat([p[i] for p in parts]) for i in range(4))
    n_all = means.shape[0]

    # footprint clamp: major-axis sigma 0.5-8 px as seen from the orbit
    r_xz = torch.linalg.vector_norm(means[:, [0, 2]], dim=1)
    d_cam = torch.sqrt((r_xz - 4.2) ** 2 + (means[:, 1] - 1.6) ** 2) + 0.3
    sigma_px = torch.clamp_min(torch.exp(log_scales.amax(1)) * FOCAL / d_cam, 1e-6)
    shift = (torch.clamp_max(torch.log(8.0 / sigma_px), 0.0)
             + torch.clamp_min(torch.log(0.5 / sigma_px), 0.0))
    log_scales = log_scales + shift[:, None]

    hi = d.uniform(0.0, 1.0, n_all) < 0.65
    opacities = torch.where(hi, d.normal(2.2, 1.2, n_all), d.normal(-0.5, 1.5, n_all))

    band = torch.tensor([1.0] * 3 + [2.0] * 5 + [3.0] * 7, device=device)
    rest = d.normal(0.0, 1.0, n_all, 3, 15) * (0.12 / (1.0 + band))
    sh = torch.cat([((colours - 0.5) / SH_C0)[:, :, None], rest], 2)

    perm = d.permutation(n_all)
    return {"means": means[perm].contiguous(), "sh": sh[perm].contiguous(),
            "opacities": opacities[perm].contiguous(),
            "log_scales": log_scales[perm].contiguous(), "quats": quats[perm].contiguous()}


def perturbed(scene: dict, seed: int, scale: float) -> dict:
    """A seeded perturbation of every field: x + scale * N(0, 1), drawn leaf
    after leaf from a generator of its own (the trainer's starting point)."""
    dev = scene["means"].device
    d = _Draw(int(seed) ^ 0x5EED, dev)
    return {k: scene[k] + scale * d.normal(0.0, 1.0, *scene[k].shape) for k in FIELDS}
