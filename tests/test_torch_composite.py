"""PyTorch port vs. the JAX package: feature packing and the composite forward,
on the CPU.

The JAX side runs its Pallas composite kernel in interpret mode (as its own
tests do); the port runs the plain version of its CUDA kernel. Both get the
same ``feats`` and the same bins. Tolerance atol 2e-5 on the [T, 8, P] rows of
tiles that hold instances: the JAX kernel scans log(1 - w) with a 1e-37 floor
and sums colours in a matrix product, the port multiplies (1 - w) factors and
sums in instance order, so rounding and summation order differ (and a fully
opaque instance leaves T ~ 1e-37 there, exactly 0 here) — all far below 2e-5.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from splatapult_tpu.io.synth import garden_cameras as jgarden_cameras
from splatapult_tpu.io.synth import make_garden_scene as jmake_garden_scene
from splatapult_tpu.ops import binning as jb, composite as jc, tiled as jt
from splatapult_tpu.render import RenderConfig as JRenderConfig
from splatapult_tpu.render import prepare_splats as jprepare_splats

from splatapult_tpu_torch.ops import binning as tb, composite as tc, tiled as tt

N, W, H = 2000, 96, 64
# One thread for torch: the suite runs several worker processes per machine,
# and an oversubscribed intra-op thread pool slows every worker down.
torch.set_num_threads(1)

GRID_KW = dict(width=W, height=H, num_splats=N, tile_size=16, block=8, max_instance_mult=4.0)


@pytest.fixture(scope="module")
def case():
    """Prepared 2k-garden splats, JAX feats and JAX bins, made once."""
    scene = jmake_garden_scene(N, seed=0)
    cam = jgarden_cameras(1, width=W, height_px=H)
    d = jprepare_splats(scene, cam, JRenderConfig(width=W, height=H), sort=False)
    feats = jt.pack_features(d["mean2d"], d["conic"], d["rgb"], d["alpha"])
    bins = jb.bin_splats(d["mean2d"], d["extent"], jb.TileGrid.create(**GRID_KW), depth=d["depth"])
    return {"d": {k: np.array(v) for k, v in d.items()}, "feats": feats, "bins": bins}


def _torch_bins(jbins):
    return {k: torch.from_numpy(np.array(v)) for k, v in jbins.items()}


def test_constants_match():
    for name in ("NUM_FEATS", "OUT_ROWS", "NULL_LN_ALPHA", "F_MX", "F_MY", "F_QA", "F_QB",
                 "F_QC", "F_LNA", "F_R", "F_G", "F_B"):
        assert getattr(tc, name) == getattr(jc, name), name


def test_pack_features_equal(case):
    d = case["d"]
    got = tt.pack_features(*(torch.from_numpy(d[k]) for k in ("mean2d", "conic", "rgb", "alpha")))
    want = np.asarray(case["feats"])
    assert got.shape == want.shape == (N + 1, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got.numpy()[-1], want[-1])  # the null row
    # everything but the one log column is the same arithmetic: bit equal
    cols = [0, 1, 2, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15]
    np.testing.assert_array_equal(got.numpy()[:, cols], want[:, cols])


@pytest.mark.parametrize("early_stop_eps", [0.0, 1e-4, 0.5], ids=["exact", "eps1e-4", "eps0.5"])
def test_composite_forward_matches(case, early_stop_eps):
    jgrid = jb.TileGrid.create(early_stop_eps=early_stop_eps, **GRID_KW)
    grid = tb.TileGrid.create(early_stop_eps=early_stop_eps, **GRID_KW)
    want = np.asarray(jc.composite_from_feats(case["feats"], case["bins"], jgrid))
    got = tc.composite_from_feats(
        torch.from_numpy(np.array(case["feats"])), _torch_bins(case["bins"]), grid).numpy()
    ok = np.asarray(case["bins"]["tile_ok"])
    assert got.shape == want.shape == (grid.num_tiles, 8, grid.tile_pixels)
    assert ok.sum() > grid.num_tiles // 2
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=2e-5)
    # rows: premultiplied rgb, alpha = 1 - T, T, three zero rows
    np.testing.assert_allclose(got[:, 3] + got[:, 4], 1.0, atol=1e-6)
    assert (got[:, 5:] == 0).all()
    # tiles with no instance come out as the background row
    assert (got[~ok, :4] == 0).all() and (got[~ok, 4] == 1).all()


def test_early_stop_skips_blocks_like_jax():
    """An opaque stack over one tile: after the first block every pixel is
    saturated, so eps > 0 skips the remaining blocks. The skip is per block,
    as in the JAX kernel, and both give the same rows."""
    n = 64
    rng = np.random.default_rng(11)
    mean2d = np.full((n, 2), 8.0, np.float32) + rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    conic = np.tile(np.asarray([[1e-4, 0.0, 1e-4]], np.float32), (n, 1))
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    alpha = np.full((n,), 0.9, np.float32)
    depth = np.arange(n, dtype=np.float32) + 1.0
    kw = dict(width=16, height=16, num_splats=n, tile_size=16, block=8, max_instance_mult=2)
    jfeats = jt.pack_features(*(jnp.asarray(a) for a in (mean2d, conic, rgb, alpha)))
    jbins = jb.bin_splats(jnp.asarray(mean2d), jnp.full((n,), 50.0), jb.TileGrid.create(**kw),
                          depth=jnp.asarray(depth))
    feats, bins = torch.from_numpy(np.array(jfeats)), _torch_bins(jbins)
    full = tc.composite_from_feats(feats, bins, tb.TileGrid.create(**kw))
    cut = tc.composite_from_feats(feats, bins, tb.TileGrid.create(early_stop_eps=1e-3, **kw))
    assert (cut[:, 4] >= full[:, 4]).all()
    assert float(full[:, 4].max()) < 1e-30 < 1e-9 < float(cut[:, 4].min())  # blocks were skipped
    want = np.asarray(jc.composite_from_feats(
        jfeats, jbins, jb.TileGrid.create(early_stop_eps=1e-3, **kw)))
    np.testing.assert_allclose(cut.numpy(), want, rtol=0, atol=2e-5)
    assert float(np.abs(cut.numpy()[:, 4] - want[:, 4]).max()) < 1e-12


def test_tile_block_ranges_agree_with_block_meta(case):
    bins = _torch_bins(case["bins"])
    start, nblk = tc.tile_block_ranges(bins["tile_count"], 8)
    meta = bins["block_meta"].numpy()
    live, first, tile = meta & 1, (meta >> 1) & 1, meta >> 2
    for t in range(len(start)):
        mine = np.nonzero((tile == t) & (live == 1))[0]
        assert len(mine) == int(nblk[t])
        if len(mine):
            assert mine[0] == int(start[t]) and first[mine[0]] == 1
            assert (np.diff(mine) == 1).all()


def test_backward_through_composite_raises(case):
    feats = torch.from_numpy(np.array(case["feats"])).requires_grad_(True)
    out = tc.composite_from_feats(feats, _torch_bins(case["bins"]), tb.TileGrid.create(**GRID_KW))
    with pytest.raises(NotImplementedError, match="training slice"):
        out.sum().backward()


@pytest.mark.parametrize("knob", [
    {"packed_colors": True}, {"packed_feats16": True}, {"accum_dtype": "bfloat16"},
], ids=["packed_colors", "packed_feats16", "bf16_accum"])
def test_composite_deferred_layouts_raise(case, knob):
    grid = tb.TileGrid.create(**GRID_KW, **knob)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tc.composite_from_feats(
            torch.from_numpy(np.array(case["feats"])), _torch_bins(case["bins"]), grid)


def test_composite_fwd_rejects_bad_arguments():
    grid = tb.TileGrid.create(**GRID_KW)
    start = torch.zeros(grid.num_tiles, dtype=torch.int32)
    with pytest.raises(ValueError):
        tc.composite_fwd(torch.zeros((grid.mcap, 8)), start, start, grid)
    with pytest.raises(ValueError):
        tc.composite_fwd(torch.zeros((grid.mcap, 16)), start.long(), start, grid)


def test_assemble_image_matches(case):
    rng = np.random.default_rng(7)
    jgrid, grid = jb.TileGrid.create(**GRID_KW), tb.TileGrid.create(**GRID_KW)
    rows = rng.uniform(0, 1, (grid.num_tiles, 8, grid.tile_pixels)).astype(np.float32)
    ok = rng.uniform(0, 1, grid.num_tiles) < 0.7
    cfg = JRenderConfig(width=W, height=H)
    want = np.asarray(jt.assemble_image(jnp.asarray(rows), jnp.asarray(ok), jgrid, cfg))
    got = tt.assemble_image(torch.from_numpy(rows), torch.from_numpy(ok), grid, cfg).numpy()
    np.testing.assert_array_equal(got, want)
