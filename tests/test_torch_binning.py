"""PyTorch port vs. the JAX package: tile binning, on the CPU.

Binning is integer plumbing, so every array bin_splats returns must equal the
JAX package's BIT FOR BIT on the same float inputs (the JAX side runs its
Pallas expand kernel in interpret mode, as its own tests do; the port runs the
plain version of its CUDA kernel).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from splatapult_tpu.io.synth import garden_cameras as jgarden_cameras
from splatapult_tpu.io.synth import make_garden_scene as jmake_garden_scene
from splatapult_tpu.ops import binning as jb
from splatapult_tpu.render import RenderConfig as JRenderConfig
from splatapult_tpu.render import prepare_splats as jprepare_splats

from splatapult_tpu_torch.ops import binning as tb

# One thread for torch: the suite runs several worker processes per machine,
# and an oversubscribed intra-op thread pool slows every worker down.
torch.set_num_threads(1)

N = 2000
W, H = 96, 64
COMPARED = ("inst_splat", "block_meta", "seg_offs", "seg_cnt", "block_tile",
            "block_first", "block_live", "tile_ok", "tile_count",
            "num_culled_instances")


@pytest.fixture(scope="module")
def splats():
    """Prepared 2k-garden splats at 96x64 (made once by the JAX package)."""
    scene = jmake_garden_scene(N, seed=0)
    cam = jgarden_cameras(1, width=W, height_px=H)
    d = jprepare_splats(scene, cam, JRenderConfig(width=W, height=H), sort=False)
    return {k: np.array(d[k]) for k in ("mean2d", "extent", "depth")}


def _both(splats, row_offset=None, depth=None, **grid_kw):
    kw = dict(width=W, height=H, num_splats=N, tile_size=16, block=8, **grid_kw)
    depth = splats["depth"] if depth is None else depth
    want = jb.bin_splats(jnp.asarray(splats["mean2d"]), jnp.asarray(splats["extent"]),
                         jb.TileGrid.create(**kw), depth=jnp.asarray(depth),
                         row_offset=row_offset)
    got = tb.bin_splats(torch.from_numpy(splats["mean2d"]), torch.from_numpy(splats["extent"]),
                        tb.TileGrid.create(**kw), depth=torch.from_numpy(depth),
                        row_offset=row_offset)
    return got, want


def _assert_bins_equal(got, want):
    for k in COMPARED:
        a, b = got[k].numpy(), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("depth_bits,mode", [(32, "exact32"), (20, "packed20"), (16, "packed16")])
def test_bin_splats_bit_equal_key_modes(splats, depth_bits, mode):
    got, want = _both(splats, max_instance_mult=4.0, depth_bits=depth_bits)
    grid = tb.TileGrid.create(W, H, N, tile_size=16, block=8, depth_bits=depth_bits)
    assert tb.sort_key_mode(grid) == mode
    assert int(got["num_culled_instances"]) == 0 and int(got["tile_count"].sum()) > N // 2
    _assert_bins_equal(got, want)


def test_bin_splats_bit_equal_overflow_drops_farthest(splats):
    # tile 8 and 4x extents raise the demand well past the 4096-slot minimum capacity
    kw = dict(width=W, height=H, num_splats=N, tile_size=8, block=8, max_instance_mult=0.1)
    args = (splats["mean2d"], splats["extent"] * np.float32(4.0))
    want = jb.bin_splats(*map(jnp.asarray, args), jb.TileGrid.create(**kw),
                         depth=jnp.asarray(splats["depth"]))
    got = tb.bin_splats(*map(torch.from_numpy, args), tb.TileGrid.create(**kw),
                        depth=torch.from_numpy(splats["depth"]))
    culled = int(got["num_culled_instances"])
    assert culled > 0 and int(got["tile_count"].sum()) <= 4096
    _assert_bins_equal(got, want)
    # what was dropped is the far end: no kept splat is farther than a dropped one
    cnt = got["seg_cnt"].numpy()
    raw = tb._tile_rects(*map(torch.from_numpy, args), tb.TileGrid.create(**kw))[4].numpy()
    dropped = (raw > 0) & (cnt == 0)
    assert splats["depth"][cnt > 0].max() <= splats["depth"][dropped].min()
    demand = int(tb.instance_demand(*map(torch.from_numpy, args), tb.TileGrid.create(**kw)))
    assert demand == culled + int(cnt.sum())


@pytest.mark.parametrize("row_offset", [0, 1])
def test_bin_splats_bit_equal_row_stride(splats, row_offset):
    got, want = _both(splats, row_offset=row_offset, max_instance_mult=4.0, row_stride=2)
    _assert_bins_equal(got, want)
    # only owned tile rows hold instances
    rows = np.arange(got["tile_count"].shape[0]) // (-(-W // 16))
    assert (got["tile_count"].numpy()[rows % 2 != row_offset] == 0).all()
    assert got["tile_count"].numpy()[rows % 2 == row_offset].sum() > 0


@pytest.mark.parametrize("depth_bits", [32, 20])
def test_bin_splats_bit_equal_duplicate_depths(splats, depth_bits):
    # few distinct depths: order inside a tile falls to the descending-splat tie-break
    depth = np.round(splats["depth"] * 0.5).astype(np.float32) * 2.0
    assert len(np.unique(depth)) < 40
    got, want = _both(splats, depth=depth, max_instance_mult=4.0, depth_bits=depth_bits)
    _assert_bins_equal(got, want)


def test_depth_tie_break_descending_splat_index():
    grid = tb.TileGrid.create(width=32, height=32, num_splats=4, tile_size=16, block=8)
    mean2d = torch.tensor([[8.0, 8.0]] * 4)
    bins = tb.bin_splats(mean2d, torch.full((4,), 2.0), grid,
                         depth=torch.tensor([2.0, 1.0, 2.0, 1.0]))
    inst = bins["inst_splat"].numpy()
    assert inst[inst < 4].tolist() == [3, 1, 2, 0]


def test_strict_tile_count_gates_fall_back_to_exact():
    # exactly 2048 tiles: the 20-bit sentinel key would wrap int32
    g = tb.TileGrid.create(width=64 * 16, height=32 * 16, num_splats=8, tile_size=16, depth_bits=20)
    assert g.num_tiles == 2048 and tb.sort_key_mode(g) == "exact32"
    g = tb.TileGrid.create(width=64 * 16 - 16, height=32 * 16, num_splats=8, tile_size=16, depth_bits=20)
    assert g.num_tiles < 2048 and tb.sort_key_mode(g) == "packed20"
    jg = jb.TileGrid.create(width=64 * 16, height=32 * 16, num_splats=8, tile_size=16, depth_bits=20)
    assert jb.sort_key_mode(jg) == "exact32"


def test_grid_geometry_matches():
    for kw in (dict(width=1920, height=1080, num_splats=1_500_000, max_instance_mult=1.59),
               dict(width=96, height=64, num_splats=2000, tile_size=16, block=8, row_stride=2)):
        g, jg = tb.TileGrid.create(**kw), jb.TileGrid.create(**kw)
        for f in ("emax", "mcap", "tiles_x", "tiles_y", "num_tiles", "num_blocks", "tile_pixels"):
            assert getattr(g, f) == getattr(jg, f), f
    with pytest.raises(ValueError):
        tb.TileGrid.create(width=96, height=48, num_splats=10, tile_size=16, row_stride=2)


def test_instance_demand_and_rects_match(splats):
    kw = dict(width=W, height=H, num_splats=N, tile_size=16, block=8)
    args = (splats["mean2d"], splats["extent"])
    want = jb._tile_rects(*map(jnp.asarray, args), jb.TileGrid.create(**kw))
    got = tb._tile_rects(*map(torch.from_numpy, args), tb.TileGrid.create(**kw))
    live = np.asarray(want[4]) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy()[live], np.asarray(b)[live])
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert int(tb.instance_demand(*map(torch.from_numpy, args), tb.TileGrid.create(**kw))) == int(
        jb.instance_demand(*map(jnp.asarray, args), jb.TileGrid.create(**kw)))


def test_plain_expand_matches_jax_kernel_output(splats):
    """The plain expand against the JAX [3, emax] Pallas kernel output, fed the
    same table (the JAX kernel takes offsets and a packed tile0|nx column)."""
    kw = dict(width=W, height=H, num_splats=N, tile_size=16, block=8, max_instance_mult=4.0)
    grid, jgrid = tb.TileGrid.create(**kw), jb.TileGrid.create(**kw)
    table = tb.expand_table(torch.from_numpy(splats["mean2d"]), torch.from_numpy(splats["extent"]),
                            grid, torch.from_numpy(splats["depth"]))
    got = tb.expand_fill(table["ends"], table["tile0"], table["nx"], table["dbits"],
                         grid.emax, grid.tiles_x)
    total = int(table["ends"][-1])
    assert got.shape == (3, grid.emax) and got.dtype == torch.int32
    assert (got[:, total:] == 0).all()  # uncovered slots

    # build the JAX kernel's operands the way its bin_splats does
    cnt = table["cnt"].numpy()
    offs = table["ends"].numpy() - cnt
    kept = cnt > 0
    fbt = max(int(grid.num_tiles).bit_length(), 1)
    fbn = max(int(grid.tiles_x).bit_length(), 1)
    ob = max(grid.emax.bit_length(), N.bit_length(), 1)
    ctab, wblk, chunk = jb._EXPAND_CTAB, jb._EXPAND_WBLK, jb._EXPAND_C
    n_pad = (-(-N // ctab) + wblk) * ctab
    sent = (1 << ob) - 1
    order = np.argsort(~kept, kind="stable")  # kept rows to a prefix

    def col(values, fill):
        out = np.full(n_pad, fill, np.int32)
        out[:N] = values[order]
        return jnp.asarray(out)

    dbits = table["dbits"].numpy()
    offs_c = col(np.where(kept, offs, sent).astype(np.int32), sent)
    tnx_c = col(((table["tile0"].numpy() << fbn) | np.maximum(table["nx"].numpy(), 1)).astype(np.int32), 0)
    starts = np.arange(grid.emax // chunk, dtype=np.int32) * chunk
    lo = np.clip(np.searchsorted(np.asarray(offs_c), starts, side="right") - 1, 0, n_pad - 1)
    lo_blk = jnp.asarray(np.clip(lo // ctab, 0, n_pad // ctab - wblk).astype(np.int32))
    want = np.asarray(jb._expand_fill_pallas(
        offs_c, tnx_c, col(dbits >> 16, 0), col(dbits & 0xFFFF, 0),
        col(np.arange(N, dtype=np.int32), 0), lo_blk, jgrid, fbt, fbn, ob, impl="onehot"))
    np.testing.assert_array_equal(got.numpy()[:, :total], want[:, :total])


def test_expand_fill_rejects_bad_arguments():
    ok = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        tb.expand_fill(ok.long(), ok, ok, ok, 4096, 6)
    with pytest.raises(ValueError):
        tb.expand_fill(ok, ok[:3], ok, ok, 4096, 6)
