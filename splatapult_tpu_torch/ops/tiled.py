"""Tiled render path: binning + gather + composite kernel + image assembly.

The production pipeline for real scene sizes. The binning indices are
non-differentiable plumbing; this slice is forward only (see ops/composite.py).
"""

from __future__ import annotations

import torch

from splatapult_tpu_torch.ops.binning import TileGrid, bin_splats
from splatapult_tpu_torch.ops.composite import (
    NULL_LN_ALPHA,
    NUM_FEATS,
    composite_from_feats,
)


def _grid_from_config(config, num_splats: int, row_stride: int = 1) -> TileGrid:
    return TileGrid.create(
        width=config.width,
        height=config.height,
        num_splats=num_splats,
        tile_size=config.tile_size,
        block=config.tile_block,
        max_instance_mult=config.max_instance_mult,
        alpha_cutoff=config.alpha_cutoff,
        early_stop_eps=config.early_stop_eps,
        accum_dtype=config.accum_dtype,
        grad_sort_dtype=config.grad_sort_dtype,
        packed_colors=config.packed_colors,
        forward_only=config.forward_only,
        depth_bits=config.depth_bits,
        packed_feats16=config.packed_feats16,
        row_stride=row_stride,
    )


def pack_features(mean2d, conic, rgb, alpha):
    """[N] splat tensors -> [N + 1, 16] feature rows; last row is the null splat.

    The kernel parameterization folds the opacity into the exponent
    (ops/composite.py): qa = -a/2, qb = -b, qc = -c/2 and ln(alpha), so
    w = alpha * exp(-0.5 q) is a single exp.
    """
    n = mean2d.shape[0]
    # columns written into one preallocated table (zero = the unused columns
    # and the null row): concatenating narrow tensors along the last dim is
    # the slowest path of the CUDA cat kernel
    feats = torch.zeros((n + 1, NUM_FEATS), dtype=mean2d.dtype, device=mean2d.device)
    feats[:n, 0:2] = mean2d
    feats[:n, 2:5] = conic * torch.tensor([-0.5, -1.0, -0.5], dtype=conic.dtype,
                                          device=conic.device)
    feats[:n, 5] = torch.log(torch.clamp_min(alpha, 1e-37))
    feats[:n, 6:9] = rgb
    feats[n, 5] = NULL_LN_ALPHA
    return feats


def assemble_image(out, tile_ok, grid: TileGrid, config) -> torch.Tensor:
    """Per-tile kernel output [T, 8, P] -> [H, W, 4] image (row 0 = top)."""
    # tiles with no instance -> transparent background, whatever the rows hold
    background = torch.tensor([0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0],
                              dtype=out.dtype, device=out.device)
    out = torch.where(tile_ok[:, None, None], out, background[None, :, None])

    ts = grid.tile_size
    img = (
        out[:, :4, :]
        .reshape(grid.tiles_y, grid.tiles_x, 4, ts, ts)
        .permute(0, 3, 1, 4, 2)
        .reshape(grid.tiles_y * ts, grid.tiles_x * ts, 4)
    )
    return img[: config.height, : config.width, :].to(torch.float32)


def composite_tiled(splats, config, return_aux: bool = False):
    """Render prepared (unsorted) splats through the tiled pipeline -> [H, W, 4]."""
    if getattr(config, "sort_bands", 1) > 1:
        raise NotImplementedError(
            "sort_bands > 1 is not ported (ROADMAP queue 1 item 16: a TPU "
            "sort-cliff workaround, measured negative there)")
    mean2d = splats["mean2d"]
    n = mean2d.shape[0]
    grid = _grid_from_config(config, n)

    bins = bin_splats(mean2d.detach(), splats["extent"].detach(), grid,
                      depth=splats["depth"].detach())
    feats = pack_features(mean2d, splats["conic"], splats["rgb"], splats["alpha"])
    out = composite_from_feats(feats, bins, grid)
    img = assemble_image(out, bins["tile_ok"], grid, config)
    if return_aux:
        return img, {
            "num_culled_instances": bins["num_culled_instances"],
            "tile_count": bins["tile_count"],
        }
    return img
