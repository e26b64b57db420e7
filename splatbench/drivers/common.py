"""What the drivers share: the program's render config from a configuration
file, the cameras handed to it, the frame's composition in spans, its
dropped-instance counter, and the comparison of images with the reference."""

from __future__ import annotations

import importlib
import statistics

import torch
from torch.profiler import record_function

# configuration keys that are the program's RenderConfig fields
RENDER_KEYS = ("width", "height", "tile_size", "tile_block", "alpha_cutoff", "early_stop_eps",
               "depth_bits", "packed_colors", "grad_sort_dtype", "accum_dtype")


def program_config(config: dict, traffic: dict, overrides: dict):
    """The cell's render.RenderConfig (tiled pipeline), before calibration;
    ``overrides`` switches on one of the program's own paths (the control)."""
    R = importlib.import_module("splatapult_tpu_torch.render")

    knobs = {k: config[k] for k in RENDER_KEYS}
    knobs.update(overrides)
    return R.RenderConfig(pipeline="tiled", forward_only=traffic["forward_only"], **knobs)


def program_cameras(views, device):
    """[(c2w, proj)] numpy pairs -> (a render.Camera each, one [V]-batched)."""
    R = importlib.import_module("splatapult_tpu_torch.render")

    mats = torch.stack([torch.from_numpy(c) for c, _ in views]).to(device)
    projs = torch.stack([torch.from_numpy(p) for _, p in views]).to(device)
    cams = [R.Camera(cam_to_world=mats[i], proj=projs[i]) for i in range(len(views))]
    return cams, R.Camera(cam_to_world=mats, proj=projs)


def forward_in_spans(scene, cam, rcfg):
    """``render.render``'s composition of the tiled pipeline, each layer in a
    profiler span of its own (prepare, binning, composite, assemble) -> the
    image."""
    R = importlib.import_module("splatapult_tpu_torch.render")
    from splatapult_tpu_torch.ops import binning, tiled
    from splatapult_tpu_torch.ops.composite import composite_from_feats

    with record_function("prepare"):
        d = R.prepare_splats(scene, cam, rcfg, sort=False)
    grid = tiled._grid_from_config(rcfg, scene.means.shape[0])
    with record_function("binning"):
        bins = binning.bin_splats(d["mean2d"].detach(), d["extent"].detach(), grid,
                                  depth=d["depth"].detach())
    with record_function("composite"):
        feats = tiled.pack_features(d["mean2d"], d["conic"], d["rgb"], d["alpha"])
        rows = composite_from_feats(feats, bins, grid)
    with record_function("assemble"):
        return tiled.assemble_image(rows, bins["tile_ok"], grid, rcfg)


def dropped_instances(scene, cams, rcfg, views) -> dict:
    """The program's own count of instances its capacity dropped, per view
    (ops/tiled.composite_tiled's ``num_culled_instances``) -> {view: count}."""
    R = importlib.import_module("splatapult_tpu_torch.render")
    from splatapult_tpu_torch.ops import tiled

    views = sorted(set(views))
    counts = []
    with torch.no_grad():
        for v in views:
            d = R.prepare_splats(scene, cams[v], rcfg, sort=False)
            counts.append(tiled.composite_tiled(d, rcfg, return_aux=True)[1]
                          ["num_culled_instances"])
    return dict(zip(views, torch.stack(counts).cpu().tolist())) if views else {}


def image_errors(image: torch.Tensor, ref: torch.Tensor) -> dict:
    """|image - reference| over every value -> {"img_err_mean", "img_err_p999"}."""
    err = (image.to(ref.device, torch.float64) - ref).abs().flatten()
    if not bool(torch.isfinite(err).all()):
        return {"img_err_mean": float("inf"), "img_err_p999": float("inf")}
    k = max(1, int(0.999 * err.numel()))
    return {"img_err_mean": float(err.mean()), "img_err_p999": float(err.kthvalue(k).values)}


def worst(per_item: list) -> dict:
    """The largest value of each number over the compared items."""
    return {k: max(d[k] for d in per_item) for k in per_item[0]} if per_item else {}


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn with ``rng``:
    offer(i) -> the slot item i takes, or None."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.seen, self.items = k, rng, 0, [None] * k

    def offer(self, item):
        i = self.seen
        self.seen += 1
        slot = i if i < self.k else self.rng.randrange(i + 1)
        if slot < self.k:
            self.items[slot] = item
            return slot
        return None


def quantile(values, q: float) -> float:
    """statistics.quantiles' inclusive estimate of the q-th quantile."""
    vals = sorted(values)
    if len(vals) == 1:
        return vals[0]
    n = 100
    return statistics.quantiles(vals, n=n, method="inclusive")[round(q * n) - 1]

