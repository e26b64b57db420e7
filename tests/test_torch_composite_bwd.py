"""PyTorch port vs. the JAX package: the composite backward (the plain version
of the CUDA kernel, and the per-splat tail), on the CPU.

The JAX side runs its Pallas backward kernel in interpret mode (as its own
tests do); the port runs the plain version of its CUDA kernel. Both get the
same instance rows, bins, forward output and a random cotangent.

Tolerance: every gradient column agrees within 2e-4 of that column's largest
magnitude (observed: below 1e-4). The JAX kernel takes its prefix products in
log space with a 1e-37 floor and its prefix and pixel sums as matrix products;
the port multiplies (1 - w) factors and sums with cumsum/einsum, so rounding
and summation order differ. Blocks that the early stop skips, and blocks no
tile owns, are exactly zero on both sides; splats with no instance get an
exactly zero gradient row on both sides.

The CUDA kernels do not walk a tile's chain in one piece: they cut it into
segments of SEGMENT_BLOCKS blocks. The forward walks each segment from
colour 0 and T = 1 and combines the segments' locals per tile, which also
gives the checkpoints (colour so far, T) that the backward starts each
segment from. What they rely on is tested here in plain PyTorch on hand-made
chains (no JAX needed): the numbering of the segments, the checkpoints and
walked-block counts as a by-product of composite_fwd_plain, that the segment
pass and the combine (composite_fwd_segments_plain, combine_segments_plain)
give the same rows, checkpoints and walked-block counts within 1e-6 (float
association: C + T * c per segment instead of one running sum), and that a
backward assembled from per-segment replays started at the checkpoints equals
composite_bwd_plain within 1e-6 of each column's largest magnitude (the only
difference: S at a segment's start is dRGB . colour so far instead of the
running sum, float association).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from splatapult_tpu.io.synth import garden_cameras as jgarden_cameras
from splatapult_tpu.io.synth import make_garden_scene as jmake_garden_scene
from splatapult_tpu.ops import binning as jb, composite as jc, tiled as jt
from splatapult_tpu.render import RenderConfig as JRenderConfig
from splatapult_tpu.render import prepare_splats as jprepare_splats

from splatapult_tpu_torch.ops import binning as tb, composite as tc

N, W, H = 2000, 96, 64
# One thread for torch: the suite runs several worker processes per machine,
# and an oversubscribed intra-op thread pool slows every worker down.
torch.set_num_threads(1)

GRID_KW = dict(width=W, height=H, num_splats=N, tile_size=16, block=8, max_instance_mult=4.0)
REL_TOL = 2e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _torch_bins(jbins):
    return {k: _t(v) for k, v in jbins.items()}


def _close_by_column(got, want, axis):
    """Each gradient column within REL_TOL of its own largest magnitude."""
    other = tuple(i for i in range(want.ndim) if i != axis)
    scale = np.abs(want).max(axis=other, keepdims=True)
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= REL_TOL * scale + 1e-12).all(), (
        (np.abs(got - want) / np.maximum(scale, 1e-30)).max(axis=other))


@pytest.fixture(scope="module")
def garden():
    """Prepared 2k-garden splats -> JAX feats and bins, made once."""
    scene = jmake_garden_scene(N, seed=0)
    cam = jgarden_cameras(1, width=W, height_px=H)
    d = jprepare_splats(scene, cam, JRenderConfig(width=W, height=H), sort=False)
    feats = jt.pack_features(d["mean2d"], d["conic"], d["rgb"], d["alpha"])
    bins = jb.bin_splats(d["mean2d"], d["extent"], jb.TileGrid.create(**GRID_KW), depth=d["depth"])
    return {"feats": feats, "bins": bins, "kw": GRID_KW}


@pytest.fixture(scope="module")
def stack():
    """64 nearly opaque, very wide splats over the whole image (the other
    splats culled): every pixel saturates inside a tile's first block, so an
    early stop skips the other seven. Same array shapes as the garden case,
    so the JAX side compiles nothing new."""
    n = 64
    rng = np.random.default_rng(11)
    mean2d = np.zeros((N, 2), np.float32)
    mean2d[:n] = np.asarray([W / 2, H / 2], np.float32) + rng.uniform(-1, 1, (n, 2))
    conic = np.tile(np.asarray([[1e-5, 0.0, 1e-5]], np.float32), (N, 1))
    rgb = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    alpha = np.zeros((N,), np.float32)
    alpha[:n] = 0.9
    extent = np.zeros((N, 2), np.float32)
    extent[:n] = 200.0
    feats = jt.pack_features(*(jnp.asarray(a) for a in (mean2d, conic, rgb, alpha)))
    bins = jb.bin_splats(jnp.asarray(mean2d), jnp.asarray(extent), jb.TileGrid.create(**GRID_KW),
                         depth=jnp.asarray(np.arange(N, dtype=np.float32) + 1.0))
    return {"feats": feats, "bins": bins, "kw": GRID_KW}


def _both_sides(case, **knobs):
    """The JAX kernel's and the port's [9, mcap] columns on the same inputs."""
    jgrid = jb.TileGrid.create(**case["kw"], **knobs)
    grid = tb.TileGrid.create(**case["kw"], **knobs)
    bins = case["bins"]
    inst = case["feats"][bins["inst_splat"]]
    out = jc._fwd_call(inst, bins["block_meta"], jgrid)
    rng = np.random.default_rng(5)
    dout = rng.standard_normal(out.shape).astype(np.float32)  # rows 0-4 all non-zero
    want = np.asarray(jc._bwd_call(inst, bins["block_meta"], out, jnp.asarray(dout), jgrid))
    start, nblk = tc.tile_block_ranges(_t(bins["tile_count"]), grid.block)
    got = tc.composite_bwd(_t(inst), start, nblk, _t(out), _t(dout), grid).numpy()
    return got, want, grid, np.asarray(bins["block_meta"])


@pytest.mark.parametrize("alpha_cutoff", [1.0 / 256.0, 0.0], ids=["cutoff", "nocutoff"])
@pytest.mark.parametrize("early_stop_eps", [0.0, 1e-4, 0.5], ids=["exact", "eps1e-4", "eps0.5"])
def test_composite_bwd_plain_matches_jax_kernel(garden, early_stop_eps, alpha_cutoff):
    got, want, grid, meta = _both_sides(garden, early_stop_eps=early_stop_eps,
                                        alpha_cutoff=alpha_cutoff)
    assert got.shape == want.shape == (tc.NUM_GRAD_COLS, grid.mcap)
    assert np.abs(want).max() > 0.1
    _close_by_column(got, want, axis=0)
    # blocks past every tile's list (not live) are exactly zero
    dead = np.repeat((meta & 1) == 0, grid.block)
    assert dead.any() and (got[:, dead] == 0).all() and (want[:, dead] == 0).all()


def test_composite_bwd_early_stop_skips_blocks_like_jax(stack):
    got, want, grid, _ = _both_sides(stack, early_stop_eps=1e-3)
    _close_by_column(got, want, axis=0)
    skipped_got = (got.reshape(9, -1, grid.block) == 0).all(axis=(0, 2))
    skipped_want = (want.reshape(9, -1, grid.block) == 0).all(axis=(0, 2))
    np.testing.assert_array_equal(skipped_got, skipped_want)
    # every tile holds all 64 splats = 8 blocks: the first runs, 7 are skipped
    assert not skipped_got[0] and skipped_got[1:8].all()
    assert (~skipped_got).sum() == grid.num_tiles
    full, full_want, _, _ = _both_sides(stack)
    _close_by_column(full, full_want, axis=0)
    assert not (full.reshape(9, -1, grid.block) == 0).all(axis=(0, 2))[:8 * grid.num_tiles].any()


@pytest.mark.parametrize("early_stop_eps", [0.0, 1e-4], ids=["exact", "eps1e-4"])
def test_composite_from_feats_vjp_matches_jax(garden, early_stop_eps):
    """Kernel + tail: the cotangent of feats, [N + 1, 16]."""
    jgrid = jb.TileGrid.create(early_stop_eps=early_stop_eps, **GRID_KW)
    grid = tb.TileGrid.create(early_stop_eps=early_stop_eps, **GRID_KW)
    out, vjp = jax.vjp(lambda f: jc.composite_from_feats(f, garden["bins"], jgrid),
                       garden["feats"])
    dout = np.random.default_rng(9).standard_normal(out.shape).astype(np.float32)
    want = np.asarray(vjp(jnp.asarray(dout))[0])
    feats = _t(garden["feats"]).requires_grad_(True)
    tc.composite_from_feats(feats, _torch_bins(garden["bins"]), grid).backward(_t(dout))
    got = feats.grad.numpy()
    assert got.shape == want.shape == (N + 1, tc.NUM_FEATS)
    _close_by_column(got[:, :9], want[:, :9], axis=1)
    assert (got[:, 9:] == 0).all() and (got[N] == 0).all()
    # splats with no instance: exactly zero rows, the same rows on both sides
    no_inst = np.asarray(garden["bins"]["seg_cnt"]) == 0
    assert 100 < no_inst.sum() < N - 100
    assert (got[:N][no_inst] == 0).all() and (want[:N][no_inst] == 0).all()
    assert (np.abs(got[:N][~no_inst]).sum(axis=1) > 0).mean() > 0.9


def test_per_splat_sums_equal_scatter_add(garden):
    """The sort-and-difference tail against the direct scatter it replaces."""
    grid = tb.TileGrid.create(**GRID_KW)
    bins = _torch_bins(garden["bins"])
    rng = np.random.default_rng(2)
    d_inst = torch.from_numpy(rng.standard_normal((9, grid.mcap)).astype(np.float32))
    d_inst[:, bins["inst_splat"] == N] = 0.0  # null and padding slots carry zeros
    got = tc.per_splat_sums(d_inst, bins["inst_splat"], bins["seg_offs"], bins["seg_cnt"], grid)
    want = torch.zeros((N + 1, 9), dtype=torch.float64).index_add_(
        0, bins["inst_splat"].long(), d_inst.t().double())
    # (the prefix sum runs in float64: test_per_splat_sums_keep_a_small_splat)
    np.testing.assert_allclose(got[:, :9].numpy(), want.numpy(), rtol=0, atol=2e-4)
    assert (got[:, 9:] == 0).all()


def test_per_splat_sums_keep_a_small_splat():
    """Splats of small gradients after a running total of 3e7: each sum keeps
    its own precision (a float32 prefix sum would lose all of it, since a
    difference of two prefixes rounds relative to the running total);
    segments inside one prefix block and over two and more, and a splat with
    no instance (exactly 0)."""
    b = tc._PREFIX_BLOCK
    counts = [3 * b + 7, 5, b, 4 * b + 3, 0, 9]  # instances of each splat, in splat order
    n = len(counts)
    grid = tb.TileGrid.create(width=32, height=32, num_splats=n, tile_size=16, block=8,
                              max_instance_mult=sum(counts) / n)
    rng = np.random.default_rng(4)
    scale = np.repeat([1e4, 1e-3, 1.0, 1e2, 0.0, 1e-2], counts)
    vals = (rng.uniform(0.5, 1.5, (9, len(scale))) * scale).astype(np.float32)
    d_inst = np.zeros((9, grid.mcap), np.float32)
    ids = np.full(grid.mcap, n, np.int32)
    slots = rng.permutation(grid.mcap)[: len(scale)]  # any order: the tail sorts by splat
    d_inst[:, slots], ids[slots] = vals, np.repeat(np.arange(n), counts)
    cnt = np.asarray(counts, np.int32)
    got = tc.per_splat_sums(torch.from_numpy(d_inst), torch.from_numpy(ids),
                            torch.from_numpy(np.cumsum(cnt) - cnt).int(), torch.from_numpy(cnt),
                            grid)[:n, :9].numpy()
    want = np.stack([vals[:, np.repeat(np.arange(n), counts) == i].astype(np.float64).sum(1)
                     for i in range(n)])
    assert (got[4] == 0.0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_backward_contracts_raise(garden):
    feats = _t(garden["feats"]).requires_grad_(True)
    bins = _torch_bins(garden["bins"])
    out = tc.composite_from_feats(feats, bins, tb.TileGrid.create(forward_only=True, **GRID_KW))
    with pytest.raises(ValueError, match="forward_only=True"):
        out.sum().backward()
    # the bf16 gradient tail is ported (tests/test_torch_packed.py holds it
    # against the JAX package): the backward runs, and a cotangent of rows in
    # another dtype than the forward's is what composite_bwd refuses
    out = tc.composite_from_feats(
        feats, bins, tb.TileGrid.create(grad_sort_dtype="bfloat16", **GRID_KW))
    out.sum().backward()
    assert bool(torch.isfinite(feats.grad).all()) and float(feats.grad.abs().max()) > 0.0
    grid = tb.TileGrid.create(accum_dtype="bfloat16", **GRID_KW)
    start, nblk = tc.tile_block_ranges(bins["tile_count"], grid.block)
    rows = torch.zeros((grid.num_tiles, 8, grid.tile_pixels))
    with pytest.raises(ValueError, match="bfloat16"):
        tc.composite_bwd(feats.detach()[bins["inst_splat"].long()], start, nblk, rows, rows,
                         grid)


def test_composite_bwd_rejects_bad_arguments():
    grid = tb.TileGrid.create(**GRID_KW)
    start = torch.zeros(grid.num_tiles, dtype=torch.int32)
    inst = torch.zeros((grid.mcap, 16))
    rows = torch.zeros((grid.num_tiles, 8, grid.tile_pixels))
    with pytest.raises(ValueError, match="inst"):
        tc.composite_bwd(inst[:, :8], start, start, rows, rows, grid)
    with pytest.raises(ValueError, match="tile_nblk"):
        tc.composite_bwd(inst, start, start.long(), rows, rows, grid)
    with pytest.raises(ValueError, match="dout"):
        tc.composite_bwd(inst, start, start, rows, rows[:, :5], grid)
    with pytest.raises(ValueError, match="out_res"):
        tc.composite_bwd(inst, start, start, rows.double(), rows, grid)
    assert tc.NUM_GRAD_COLS == jc.NUM_GRAD_COLS == 9


# ---- the segments the CUDA kernel works by, in plain PyTorch on hand-made chains

K = tc.SEGMENT_BLOCKS
# blocks per tile: none, one, around one segment, four tiles of three
# segments and two of two. An opaque wall (CHAIN_WALLS: tile -> block the wall
# fills) cuts a chain short under an early stop: before the first segment
# ends, exactly at a segment boundary, inside the second segment, and inside
# the last segment of a 2K-block chain; the last wall fills the last block of a
# (K + 2)-block chain, so T falls under eps only after the chain ends and no
# block is skipped
CHAIN_DEPTHS = [0, 1, K - 1, K, K + 1, 3 * K, 3 * K, 3 * K, 3 * K, 2 * K, K + 2]
CHAIN_WALLS = {6: 2, 7: K - 1, 8: K + 2, 9: K + 4, 10: K + 1}
CHAIN_TS, CHAIN_BLOCK = 8, 4


@pytest.fixture(scope="module")
def chains():
    """A one-row image of len(CHAIN_DEPTHS) tiles whose instance buffer is
    filled by hand: random splats near each tile's centre, CHAIN_DEPTHS blocks
    per tile, null rows elsewhere."""
    rng = np.random.default_rng(3)
    nt = len(CHAIN_DEPTHS)
    grid = tb.TileGrid.create(width=nt * CHAIN_TS, height=CHAIN_TS, num_splats=1,
                              tile_size=CHAIN_TS, block=CHAIN_BLOCK)
    inst = np.zeros((grid.mcap, tc.NUM_FEATS), np.float32)
    inst[:, tc.F_LNA] = tc.NULL_LN_ALPHA
    nblk = np.asarray(CHAIN_DEPTHS, np.int32)
    start = (np.cumsum(nblk) - nblk).astype(np.int32)

    def fill(tiles):
        for t in tiles:
            r0, r1 = start[t] * CHAIN_BLOCK, (start[t] + nblk[t]) * CHAIN_BLOCK
            n = r1 - r0
            centre = np.asarray([t * CHAIN_TS + CHAIN_TS / 2, CHAIN_TS / 2], np.float32)
            inst[r0:r1, 0:2] = centre + rng.uniform(-5, 5, (n, 2))
            inst[r0:r1, tc.F_QA] = -rng.uniform(0.02, 0.2, n)
            inst[r0:r1, tc.F_QB] = rng.uniform(-0.02, 0.02, n)
            inst[r0:r1, tc.F_QC] = -rng.uniform(0.02, 0.2, n)
            inst[r0:r1, tc.F_LNA] = np.log(rng.uniform(0.01, 0.08, n))
            inst[r0:r1, tc.F_R:tc.F_B + 1] = rng.uniform(0, 1, (n, 3))
            if t in CHAIN_WALLS:  # four flat splats of opacity 0.9: T falls by 1e-4 everywhere
                w0 = r0 + CHAIN_WALLS[t] * CHAIN_BLOCK
                inst[w0:w0 + CHAIN_BLOCK, tc.F_QA:tc.F_QC + 1] = [-1e-9, 0.0, -1e-9]
                inst[w0:w0 + CHAIN_BLOCK, tc.F_LNA] = np.log(0.9)
        return rng.standard_normal((len(tiles), tc.OUT_ROWS, grid.tile_pixels)).astype(np.float32)

    # draw order: the first nine tiles and their cotangent, then the last two
    dout = np.concatenate([fill(range(9)), fill(range(9, nt))])
    return {"grid": grid, "inst": _t(inst), "start": _t(start), "nblk": _t(nblk),
            "dout": _t(dout)}


def _walked_expected(early_stop_eps):
    walked = list(CHAIN_DEPTHS)
    if early_stop_eps > 0.0:
        for t, b in CHAIN_WALLS.items():
            walked[t] = b + 1  # the block after the wall is the first one skipped
    assert walked[10] == CHAIN_DEPTHS[10]  # a wall on the last block skips nothing
    return walked


def _segments_by_hand(nblk):
    """Every (tile, first block) pair a chain list has, in tile order."""
    return [(t, j * K) for t, n in enumerate(nblk) for j in range(-(-int(n) // K))]


def test_segment_table_on_chains(chains):
    """Every segment of every chain has a number of its own below the static
    cap, in tile order, and the numbers in between belong to no segment."""
    grid, start, nblk = chains["grid"], chains["start"], chains["nblk"]
    seg0 = tc.first_segments(start)
    seg_tile, seg_blk0, live = tc.segment_table(start, nblk, grid)
    cap = tc.num_segments_cap(grid)
    assert seg_tile.shape == seg_blk0.shape == live.shape == (cap,)
    assert all(a.dtype == torch.int32 for a in (seg0, seg_tile, seg_blk0))
    assert seg0.tolist() == [int(start[t]) // K + t for t in range(grid.num_tiles)]
    want = _segments_by_hand(CHAIN_DEPTHS)
    assert len(want) == 21 == int(live.sum())
    assert list(zip(seg_tile[live].tolist(), seg_blk0[live].tolist())) == want
    # segment j of tile t sits at number seg0[t] + j
    for t, blk0 in want:
        s = int(seg0[t]) + blk0 // K
        assert bool(live[s]) and int(seg_tile[s]) == t and int(seg_blk0[s]) == blk0


@pytest.mark.parametrize("fill", ["ones", "one_deep", "random", "k_plus_one"])
def test_segment_count_never_exceeds_the_static_cap(fill):
    """Whatever way the buffer's blocks are dealt to the tiles, every segment
    gets a number of its own below num_segments_cap."""
    grid = tb.TileGrid.create(width=96, height=64, num_splats=40, tile_size=16, block=8,
                              max_instance_mult=4.0)
    nt, nb = grid.num_tiles, grid.num_blocks
    if fill == "ones":
        nblk = np.ones(nt, np.int64)
    elif fill == "one_deep":  # the last tile holds every block: the largest number there is
        nblk = np.zeros(nt, np.int64)
        nblk[-1] = nb
    elif fill == "k_plus_one":  # the most segments per block: K + 1 blocks make two
        nblk = np.zeros(nt, np.int64)
        nblk[:nb // (K + 1)] = K + 1
    else:
        nblk = np.random.default_rng(0).multinomial(nb, np.ones(nt) / nt)
    assert nblk.sum() <= nb
    nblk_t = _t(nblk.astype(np.int32))
    start = torch.cumsum(nblk_t, 0, dtype=torch.int32) - nblk_t
    seg_tile, seg_blk0, live = tc.segment_table(start, nblk_t, grid)
    want = _segments_by_hand(nblk)
    assert len(want) == int(live.sum()) <= tc.num_segments_cap(grid)
    assert list(zip(seg_tile[live].tolist(), seg_blk0[live].tolist())) == want
    last = int(tc.first_segments(start)[-1]) + -(-int(nblk[-1]) // K) - 1
    assert last < tc.num_segments_cap(grid)


@pytest.mark.parametrize("early_stop_eps", [0.0, 1e-2], ids=["exact", "eps1e-2"])
def test_forward_checkpoints_are_the_state_before_each_segment(chains, early_stop_eps):
    grid = dataclasses.replace(chains["grid"], early_stop_eps=early_stop_eps)
    inst, start, nblk = chains["inst"], chains["start"], chains["nblk"]
    out, seg = tc.composite_fwd(inst, start, nblk, grid, checkpoints=True)
    assert torch.equal(out, tc.composite_fwd(inst, start, nblk, grid))
    assert seg.walked.tolist() == _walked_expected(early_stop_eps)
    seg0 = tc.first_segments(start)
    checked = 0
    for j in range(3):
        # the forward over the first j segments of every chain
        head = tc.composite_fwd_plain(inst, start, torch.clamp_max(nblk, j * K), grid)
        for t in range(grid.num_tiles):
            if int(seg.walked[t]) > j * K:  # the forward reached segment j of tile t
                ck = seg.ckpt[int(seg0[t]) + j]
                assert torch.equal(ck[:3], head[t, :3]) and torch.equal(ck[3], head[t, 4])
                checked += 1
    assert checked == (21 if early_stop_eps == 0.0 else 16)


def _bwd_from_segments(case, out, seg, grid):
    """The backward as the kernel computes it: every segment on its own, T
    from its checkpoint and S = dRGB . (colour so far), over the blocks the
    forward walked, with no early-stop test of its own."""
    inst, start, dout = case["inst"], case["start"], case["dout"]
    no_stop = dataclasses.replace(grid, early_stop_eps=0.0)
    total = torch.zeros((tc.NUM_GRAD_COLS, grid.mcap))
    seg0 = tc.first_segments(start)
    for j in range(int(seg.walked.max() + K - 1) // K):
        ck = seg.ckpt[(seg0 + j).clamp_max(seg.ckpt.shape[0] - 1).long()]  # [T, 4, P]
        state = (ck[:, 3], (dout[:, :3] * ck[:, :3]).sum(dim=1))
        cols = tc.composite_bwd_plain(inst, start + j * K, torch.clamp(seg.walked - j * K, 0, K),
                                      out, dout, no_stop, state=state)
        assert (total[:, (cols != 0).any(dim=0)] == 0).all()  # segments own disjoint rows
        total += cols
    return total


@pytest.mark.parametrize("early_stop_eps", [0.0, 1e-2], ids=["exact", "eps1e-2"])
def test_backward_from_segment_checkpoints_equals_whole_chains(chains, early_stop_eps):
    grid = dataclasses.replace(chains["grid"], early_stop_eps=early_stop_eps)
    inst, start, nblk, dout = (chains[k] for k in ("inst", "start", "nblk", "dout"))
    out, seg = tc.composite_fwd(inst, start, nblk, grid, checkpoints=True)
    want = tc.composite_bwd(inst, start, nblk, out, dout, grid)
    got = _bwd_from_segments(chains, out, seg, grid)
    scale = want.abs().amax(dim=1, keepdim=True)
    assert float(scale.min()) > 0.1
    assert float(((got - want).abs() / scale).max()) <= 1e-6
    # rows of blocks the forward skipped are exactly zero both ways; walked ones are not
    rows_walked = torch.zeros(grid.mcap, dtype=torch.bool)
    for t, n in enumerate(_walked_expected(early_stop_eps)):
        rows_walked[int(start[t]) * CHAIN_BLOCK:(int(start[t]) + n) * CHAIN_BLOCK] = True
    assert (got[:, ~rows_walked] == 0).all() and (want[:, ~rows_walked] == 0).all()
    assert (got[:, rows_walked] != 0).any(dim=0).float().mean() > 0.9


def test_composite_bwd_ignores_segments_on_the_cpu(chains):
    """The plain version walks whole chains: with or without the forward's
    segments the CPU result is the same."""
    grid = chains["grid"]
    inst, start, nblk, dout = (chains[k] for k in ("inst", "start", "nblk", "dout"))
    out, seg = tc.composite_fwd(inst, start, nblk, grid, checkpoints=True)
    assert torch.equal(tc.composite_bwd(inst, start, nblk, out, dout, grid, seg),
                       tc.composite_bwd(inst, start, nblk, out, dout, grid))


@pytest.mark.parametrize("early_stop_eps", [0.0, 1e-2], ids=["exact", "eps1e-2"])
def test_segments_and_combine_equal_the_whole_forward(chains, early_stop_eps):
    """The two passes of the CUDA forward, in plain PyTorch: rows, walked-block
    counts and the checkpoints of every segment the walk reached, against
    composite_fwd_plain's serial walk."""
    grid = dataclasses.replace(chains["grid"], early_stop_eps=early_stop_eps)
    inst, start, nblk = chains["inst"], chains["start"], chains["nblk"]
    want, want_seg = tc.composite_fwd_plain(inst, start, nblk, grid, checkpoints=True)
    locs = tc.composite_fwd_segments_plain(inst, start, nblk, grid)
    rows = tc.combine_segments_plain(locs.clone(), inst, start, nblk, grid)
    got, seg = tc.combine_segments_plain(locs, inst, start, nblk, grid, checkpoints=True)
    assert seg.ckpt is locs  # the checkpoints are written over the locals
    assert torch.equal(got, rows)
    assert float((got - want).abs().max()) <= 1e-6
    assert seg.walked.dtype == torch.int32
    assert seg.walked.tolist() == want_seg.walked.tolist() == _walked_expected(early_stop_eps)
    reached = tc.segment_table(start, seg.walked, grid)[2]
    assert int(reached.sum()) == (21 if early_stop_eps == 0.0 else 16)
    assert float((seg.ckpt[reached] - want_seg.ckpt[reached]).abs().max()) <= 1e-6
    # the wall tiles' T really fell under eps, in the last segment too
    if early_stop_eps > 0.0:
        assert (got[list(CHAIN_WALLS), 4].amax(dim=1) < early_stop_eps).all()


def test_segment_locals_are_each_segment_walked_alone(chains):
    """Local j of tile t is segment j walked from colour 0 and T = 1, with no
    early stop even where the grid has one; numbers of no segment are zero."""
    grid = dataclasses.replace(chains["grid"], early_stop_eps=1e-2)
    inst, start, nblk = chains["inst"], chains["start"], chains["nblk"]
    locs = tc.composite_fwd_segments_plain(inst, start, nblk, grid)
    seg_tile, seg_blk0, live = tc.segment_table(start, nblk, grid)
    assert locs.shape == (tc.num_segments_cap(grid), 4, grid.tile_pixels)
    assert (locs[~live] == 0).all()
    no_stop = dataclasses.replace(grid, early_stop_eps=0.0)
    for s in torch.nonzero(live).flatten().tolist():
        t, b0 = int(seg_tile[s]), int(seg_blk0[s])
        one = torch.zeros_like(nblk)
        one[t] = min(K, int(nblk[t]) - b0)
        want = tc.composite_fwd_plain(inst, start + b0, one, no_stop)[t]
        assert torch.equal(locs[s], want[[0, 1, 2, 4]])
