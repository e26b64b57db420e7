"""The ablation microbenchmarks' plain versions (splatapult_tpu_torch/tools/
microbench_kernel.py and microbench_bwdk.py) on the CPU, against the JAX
repo's tools/microbench_kernel.py and tools/microbench_bwdk.py.

The JAX tools build their Pallas kernels inside main() and cannot run on the
CPU, so the JAX side here is each tool's block body (microbench_kernel.py:
102-132, microbench_bwdk.py:101-190) written as jnp over the blocks, on the
JAX package's own helpers (ops/composite.py: _block_weights :321,
_excl_cumprod_rows :271, _scan_rows_add :261, _tri :254, _pixel_coords :289,
_tile_centers :281, moment_basis :306), in a lax.scan over the blocks in the
Pallas grid's order: the output block of the step's tile (the forward), and
the [4, P] carry (the backward's VMEM scratch), run from step to step as the
grid runs them. ``full`` on both sides is also held against the JAX
package's own kernels, _fwd_call and _bwd_call, in interpret mode as the
JAX tests run them.

The inputs are the port's: the ball of bench.make_scene (tools/scenes.py),
8000 splats seen from bench.py's view at 64x48, 16-pixel tiles, 128-row
blocks, capacity 2 per splat, binned by the port (its bins are the JAX
package's bit for bit: test_torch_binning.py) and handed to both sides as
numpy arrays. The backward runs with an early stop of 0.3, at which the
deepest tiles' chains end early, so that each variant's own stop is held
too (the JAX tool's default 1e-4 ends no chain at this size). Tolerances:
rows within 3e-5; gradient columns within 2e-4 of each column's largest
magnitude, the port's other composite tests' (the JAX side sums with
matrix products, the port with cumsum and einsum); the variants that round
logs to bf16 are held to the same (no log of these inputs rounds a bf16
step apart between XLA's and torch's exp and log).

Also: each variant's bound counts its own function (variant_bound); the
tools parse the JAX tools' flags with their defaults and accept every
variant name of the JAX tools, and both exit 1 on a machine without a CUDA
device. The JAX programs are jitted once per module, compiled in
threads while the port runs.
"""

import dataclasses
import importlib
import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
import pytest
import torch

from splatapult_tpu.ops import binning as jb, composite as jc

from splatapult_tpu_torch.ops import composite as tc
from splatapult_tpu_torch.tools import microbench_bwdk as MB, microbench_kernel as MK, scenes
from splatapult_tpu_torch.tools import profile_phases as P

# One thread for torch: the suite runs several worker processes per machine,
# and an oversubscribed intra-op thread pool slows every worker down.
torch.set_num_threads(1)

N, W, H, TS, BLOCK, MULT = 8000, 64, 48, 16, 128, 2.0
EARLY_STOP = 0.3
ROWS_TOL, COLS_TOL = 3e-5, 2e-4
# the JAX tools' variant names (tools/microbench_kernel.py:134-135, :224;
# tools/microbench_bwdk.py:106-184)
JAX_FWD_VARIANTS = ("full", "noscan", "noexp", "scan_bf16", "nowork")
JAX_BWD_VARIANTS = ("full", "nowork", "noscan", "noscan2", "nomom", "tri_bf16", "vpu_cdot",
                    "vpu_carry", "vpu_all")


def _jax_grid(early_stop=0.0):
    return jb.TileGrid.create(width=W, height=H, num_splats=N, tile_size=TS, block=BLOCK,
                              max_instance_mult=MULT, early_stop_eps=early_stop)


def _jax_fwd_tool(grid):
    """tools/microbench_kernel.py's make_kernel(variant) for every variant, as
    a scan over the blocks -> jitted (inst, bt, bf, bl) -> {variant: [T, 8, P]}.
    Tiles no block visits keep the background rows (the port's contract)."""
    b, p, nt = grid.block, grid.tile_pixels, grid.num_tiles
    init = jnp.concatenate([jnp.zeros((4, p)), jnp.ones((1, p)), jnp.zeros((3, p))], axis=0)

    def body(variant, feats, t, rows):
        px, py = jc._pixel_coords(t, grid)
        dx = px - feats[:, 0:1]
        dy = py - feats[:, 1:2]
        qh = (feats[:, 2:3] * dx * dx + feats[:, 3:4] * dx * dy
              + feats[:, 4:5] * dy * dy + feats[:, 5:6])
        if variant == "noexp":
            w = jnp.where(qh > math.log(1 / 256), jnp.minimum(qh * 0.01, 0.99), 0.0)
        else:
            w = jnp.where(qh > math.log(1 / 256), jnp.exp(qh), 0.0)
        one_minus = 1.0 - w
        if variant == "noscan":
            excl = jnp.ones((b, p), jnp.float32)
        elif variant == "scan_bf16":
            logs = jnp.log(jnp.maximum(one_minus, 1e-37)).astype(jnp.bfloat16)
            excl = jnp.exp(jnp.dot(jc._tri(b, True).astype(jnp.bfloat16), logs,
                                   preferred_element_type=jnp.float32))
        else:
            excl = jc._excl_cumprod_rows(one_minus)
        eff = rows[4:5] * excl * w
        t_new = rows[4:5] * (excl[b - 1:b] * one_minus[b - 1:b])
        contrib = jnp.dot(jnp.transpose(feats[:, 6:9]), eff, preferred_element_type=jnp.float32)
        return jnp.concatenate([rows[0:3] + contrib, 1.0 - t_new, t_new, rows[5:]], axis=0)

    def step(outs, xs):
        feats, t, first, live = xs
        new = {}
        for v, out in outs.items():
            cur = jnp.where(first, init, out[t])
            if v != "nowork":  # nowork: the init only
                cur = lax.cond(live, lambda c, v=v: body(v, feats, t, c), lambda c: c, cur)
            new[v] = out.at[t].set(cur)
        return new, None

    def run(inst, bt, bf, bl):
        outs = {v: jnp.broadcast_to(init, (nt, 8, p)) for v in JAX_FWD_VARIANTS}
        xs = (inst.reshape(-1, b, inst.shape[1]), bt, bf == 1, bl == 1)
        return lax.scan(step, outs, xs)[0]

    return jax.jit(run)


def _jax_bwd_tool(grid):
    """tools/microbench_bwdk.py's make_kernel(variant) for every variant, as a
    scan over the blocks -> jitted (inst, bt, bf, bl, res, dout) -> {variant:
    [9, mcap]} (the tool's [B, 16] output rows' nine columns, transposed)."""
    b, p = grid.block, grid.tile_pixels
    basis = jnp.asarray(jc.moment_basis(grid))
    init = jnp.concatenate([jnp.ones((1, p)), jnp.zeros((3, p))], axis=0)
    zeros = jnp.zeros((b, 9), jnp.float32)

    def body(variant, feats, t, res, dout, carry):
        px, py = jc._pixel_coords(t, grid)
        w = jc._block_weights(feats, px, py, grid)
        one_minus = 1.0 - w
        if variant == "noscan":
            excl = jnp.ones((b, p), jnp.float32)
        elif variant == "tri_bf16":
            logs = jnp.log(jnp.maximum(one_minus, 1e-37)).astype(jnp.bfloat16)
            excl = jnp.exp(jnp.dot(jc._tri(b, True).astype(jnp.bfloat16), logs,
                                   preferred_element_type=jnp.float32))
        else:
            excl = jc._excl_cumprod_rows(one_minus)
        t_run = carry[0:1]
        t_before = t_run * excl
        eff = t_before * w
        block_prod = excl[b - 1:b] * one_minus[b - 1:b]
        d_rgb = dout[0:3]
        colors = feats[:, 6:9]
        if variant in ("vpu_cdot", "vpu_all"):
            cdot = (colors[:, 0:1] * d_rgb[0:1] + colors[:, 1:2] * d_rgb[1:2]
                    + colors[:, 2:3] * d_rgb[2:3])
        else:
            cdot = jnp.dot(colors, d_rgb, preferred_element_type=jnp.float32)
        row = (dout[3:4] - dout[4:5]) * res[4:5] - jnp.sum(
            d_rgb * (res[0:3] - carry[1:4]), axis=0, keepdims=True)
        incl_dot = eff * cdot if variant == "noscan2" else jc._scan_rows_add(eff * cdot)
        inv_om = 1.0 / jnp.maximum(one_minus, 1e-9)
        dqh = w * ((incl_dot + row) * inv_om + t_before * cdot)
        if variant == "nomom":
            six = [jnp.sum(dqh, axis=1, keepdims=True)] * 6
        else:
            mom = jnp.dot(dqh, basis, preferred_element_type=jnp.float32)
            m_uu, m_uv, m_vv, m_u, m_v, m_1 = (mom[:, k:k + 1] for k in range(6))
            tcx, tcy = jc._tile_centers(t, grid)
            mxu, myu = feats[:, 0:1] - tcx, feats[:, 1:2] - tcy
            qa, qb, qc = feats[:, 2:3], feats[:, 3:4], feats[:, 4:5]
            gx, gy = m_u - mxu * m_1, m_v - myu * m_1
            six = [-(2.0 * qa * gx + qb * gy), -(qb * gx + 2.0 * qc * gy),
                   m_uu - 2.0 * mxu * m_u + mxu * mxu * m_1,
                   m_uv - mxu * m_v - myu * m_u + mxu * myu * m_1,
                   m_vv - 2.0 * myu * m_v + myu * myu * m_1, m_1]
        dcols = jnp.dot(eff, jnp.transpose(d_rgb), preferred_element_type=jnp.float32)
        if variant in ("vpu_carry", "vpu_all"):
            c_new = carry[1:4] + jnp.concatenate(
                [jnp.sum(colors[:, ch:ch + 1] * eff, axis=0, keepdims=True) for ch in range(3)])
        else:
            c_new = carry[1:4] + jnp.dot(jnp.transpose(colors), eff,
                                         preferred_element_type=jnp.float32)
        return jnp.concatenate(six + [dcols], axis=1), jnp.concatenate([t_run * block_prod,
                                                                      c_new])

    def run(inst, bt, bf, bl, res_all, dout_all):
        def step(carries, xs):
            feats, t, first, live = xs
            res, dout = res_all[t], dout_all[t]
            new, cols = {}, {}
            for v, carry in carries.items():
                carry = jnp.where(first, init, carry)
                if v == "nowork":
                    new[v], cols[v] = carry, zeros
                    continue
                go = live & (first | (jnp.max(carry[0]) >= grid.early_stop_eps))
                cols[v], new[v] = lax.cond(
                    go, lambda c, v=v: body(v, feats, t, res, dout, c),
                    lambda c: (zeros, c), carry)
            return new, cols

        xs = (inst.reshape(-1, b, inst.shape[1]), bt, bf == 1, bl == 1)
        cols = lax.scan(step, {v: init for v in JAX_BWD_VARIANTS}, xs)[1]
        return {v: c.reshape(-1, 9).T for v, c in cols.items()}

    return jax.jit(run)


@pytest.fixture(scope="module")
def ref():
    """The port's inputs and plain versions, and the JAX side: the two tools'
    block bodies and the package's _fwd_call / _bwd_call, compiled and run in
    threads while the port's plain versions run. The backward's forward rows
    are the port's plain full forward at the early stop, on both sides."""
    R = importlib.import_module("splatapult_tpu_torch.render")
    scene = scenes.make_scene(N, seed=0, device="cpu")
    cam = scenes.bench_camera("ball", W, H, device="cpu")
    cfg = R.RenderConfig(width=W, height=H, pipeline="tiled", tile_size=TS, tile_block=BLOCK,
                         max_instance_mult=MULT)
    grid, bins, inst, start, nblk = MK.build_inputs(scene, cam, cfg)
    es_grid = dataclasses.replace(grid, early_stop_eps=EARLY_STOP)
    jgrid, jes_grid = _jax_grid(), _jax_grid(EARLY_STOP)
    assert (jgrid.mcap, jgrid.num_tiles) == (grid.mcap, grid.num_tiles)
    meta = [jnp.asarray(bins[k].numpy()) for k in ("block_tile", "block_first", "block_live")]
    j_inst, j_meta = jnp.asarray(inst.numpy()), jnp.asarray(bins["block_meta"].numpy())
    out_res = MK.composite_fwd_variant(inst, start, nblk, es_grid, "full")
    dout = torch.from_numpy(np.random.default_rng(1).standard_normal(
        tuple(out_res.shape)).astype(np.float32))
    j_res, j_dout = jnp.asarray(out_res.numpy()), jnp.asarray(dout.numpy())

    def fwd_call(i, m):
        return jc._fwd_call(i, m, jgrid)

    def bwd_call(i, m, r, d):
        return jc._bwd_call(i, m, r, d, jes_grid)

    with ThreadPoolExecutor(4) as pool:
        jobs = {"fwd_tool": pool.submit(_jax_fwd_tool(jgrid), j_inst, *meta),
                "fwd_call": pool.submit(jax.jit(fwd_call), j_inst, j_meta),
                "bwd_tool": pool.submit(_jax_bwd_tool(jes_grid), j_inst, *meta, j_res, j_dout),
                "bwd_call": pool.submit(jax.jit(bwd_call), j_inst, j_meta, j_res, j_dout)}
        fwd = {v: MK.composite_fwd_variant(inst, start, nblk, grid, v) for v in MK.VARIANTS}
        segs = {f: MK.composite_fwd_variant(inst, start, nblk, es_grid, f, checkpoints=True)[1]
                for f in ("full", "noscan", "scan_bf16")}
        bwd = {v: MB.composite_bwd_variant(inst, start, nblk, out_res, dout, es_grid, v,
                                           segs[MB.forward_of(v)]) for v in MB.VARIANTS}
        got = {k: jax.tree_util.tree_map(np.asarray, job.result()) for k, job in jobs.items()}
    whole = tc.Segments(None, nblk)
    return {"fwd": {k: v.numpy() for k, v in fwd.items()},
            "bwd": {k: v.numpy() for k, v in bwd.items()}, **got, "mcap": grid.mcap,
            "walked": {k: s.walked.numpy() for k, s in segs.items()}, "nblk": nblk.numpy(),
            "counts": {"microbench_kernel": {"full": P.composite_counts(inst, start, whole, grid,
                                                                       4)},
                       "microbench_bwdk": {f: P.composite_counts(inst, start, s, es_grid, 4)
                                           for f, s in segs.items()}},
            "shipped_bound": {
                "microbench_kernel": P.composite_bounds(inst, start, whole, grid,
                                                        4)["composite_fwd"],
                "microbench_bwdk": P.composite_bounds(inst, start, segs["full"], es_grid,
                                                      4)["composite_bwd"]}}


def _rows_close(got, want):
    err = np.abs(got - want)
    assert err.max() <= ROWS_TOL, err.max()


def _cols_close(got, want):
    assert got.shape == want.shape
    scale = np.maximum(np.abs(want).max(axis=1, keepdims=True), 1e-30)
    err = np.abs(got - want) / scale
    assert err.max() <= COLS_TOL, err.max(axis=1)


@pytest.mark.parametrize("variant", MK.VARIANTS)
def test_fwd_variant_matches_the_jax_tool(ref, variant):
    # sub2 and sub4 keep the shipped arithmetic (right values, unlike the JAX
    # tool's sub-blocked kernel): they are held to its full body
    want = ref["fwd_tool"]["full" if variant in ("sub2", "sub4") else variant]
    got = ref["fwd"][variant]
    assert got.shape == want.shape and np.isfinite(got).all()
    _rows_close(got, want)
    full = ref["fwd"]["full"]
    if variant in MK.SHIPPED_ARITHMETIC:
        assert np.array_equal(got, full)
    else:  # the piece taken out changes the rows
        assert np.abs(got - full).max() > 1e-3


def test_fwd_full_matches_the_jax_kernel(ref):
    """full on both sides against ops/composite.py::_fwd_call (interpret)."""
    _rows_close(ref["fwd"]["full"], ref["fwd_call"])
    _rows_close(ref["fwd_tool"]["full"], ref["fwd_call"])
    assert ref["fwd_call"][:, 4].min() < 0.1  # some pixels nearly opaque


@pytest.mark.parametrize("variant", MB.VARIANTS)
def test_bwd_variant_matches_the_jax_tool(ref, variant):
    got, want = ref["bwd"][variant], ref["bwd_tool"][variant]
    assert got.shape == want.shape == (tc.NUM_GRAD_COLS, ref["mcap"])
    assert np.isfinite(got).all()
    if variant == "nowork":
        assert not got.any() and not want.any()
        return
    _cols_close(got, want)
    full = ref["bwd"]["full"]
    if MB.kernel_of(variant) == "full":
        assert np.array_equal(got, full)
    else:
        scale = np.abs(full).max(axis=1, keepdims=True)
        assert (np.abs(got - full) / scale).max() > 1e-3


def test_bwd_full_matches_the_jax_kernel_and_the_early_stop_ends_chains(ref):
    """full on both sides against ops/composite.py::_bwd_call (interpret), at
    an early stop that ends the deepest chains; each variant's forward walks
    its own blocks."""
    _cols_close(ref["bwd"]["full"], ref["bwd_call"])
    _cols_close(ref["bwd_tool"]["full"], ref["bwd_call"])
    walked, nblk = ref["walked"], ref["nblk"]
    assert (walked["full"] < nblk).sum() >= 2
    assert (walked["full"] <= walked["noscan"]).all()  # noscan's T falls later


@pytest.mark.parametrize("tool", ["microbench_kernel", "microbench_bwdk"])
def test_each_variant_bound_counts_its_own_function(ref, tool):
    """variant_bound: the variants with the shipped function get
    composite_bounds' figure; nowork is bound by the bytes it moves alone;
    the others count their own operations (fewer without the exp or the
    moments, more with bf16 logs), over their own forward's walked blocks."""
    mod = {"microbench_kernel": MK, "microbench_bwdk": MB}[tool]
    counts = ref["counts"][tool]
    forward = (lambda v: "full") if mod is MK else MB.forward_of
    bound = {v: mod.variant_bound(counts[forward(v)], v) for v in mod.VARIANTS}
    shipped = ref["shipped_bound"][tool]
    same = MK.SHIPPED_ARITHMETIC if mod is MK else ("full", "vpu_cdot", "vpu_carry", "vpu_all")
    for v in same:
        assert bound[v] == shipped, v
    assert bound["nowork"]["bound_by"] == "bytes"
    assert 0.0 < bound["nowork"]["bound_ms"] <= shipped["bound_ms"]
    pair_madds = P.FWD_PAIR_MADDS if mod is MK else P.BWD_PAIR_MADDS
    flop = {v: MK.variant_flop(counts[forward(v)], v, pair_madds, mod.PAIR_MADDS_CHANGED)
            for v in mod.VARIANTS if v != "nowork"}
    fewer, more = (("noexp",), ("scan_bf16",)) if mod is MK else (("nomom",), ("tri_bf16",))
    for v in fewer:
        assert flop[v] < flop["full"], v
    for v in more:
        assert flop[v] > flop["full"], v
    if mod is MB:  # noscan and tri_bf16 count the blocks their own forwards walked
        assert counts["noscan"]["walked_blocks"] >= counts["full"]["walked_blocks"]


@pytest.mark.parametrize("tool", ["microbench_kernel", "microbench_bwdk"])
def test_tool_flags_and_defaults(tool):
    """The JAX tool's flags with its defaults (microbench_kernel.py:31-38,
    microbench_bwdk.py:27-35), and every variant name of the JAX tool."""
    mod = {"microbench_kernel": MK, "microbench_bwdk": MB}[tool]
    args = mod.parse_args([])
    assert (args.splats, args.width, args.height, args.iters, args.instance_mult,
            args.tile_size, args.tile_block, args.scene) == (
        1_000_000, 1920, 1080, 5, 2.0, 32, 128, "ball")
    if tool == "microbench_kernel":
        jax_names = JAX_FWD_VARIANTS + ("sub2", "sub4")
        assert args.variants == list(jax_names)
    else:
        jax_names = JAX_BWD_VARIANTS
        assert args.early_stop == 1e-4
        assert args.variants == ["full", "nowork", "noscan", "noscan2", "nomom"]
    assert mod.parse_args(["--variants", ",".join(jax_names)]).variants == list(jax_names)
    with pytest.raises(SystemExit):
        mod.parse_args(["--variants", "full,nosuch"])


@pytest.mark.parametrize("tool", ["microbench_kernel", "microbench_bwdk"])
def test_tool_exits_1_without_a_cuda_device(tool, capsys, monkeypatch):
    mod = {"microbench_kernel": MK, "microbench_bwdk": MB}[tool]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main(["--splats", "1000"]) == 1
    out, err = capsys.readouterr()
    assert out == "" and f"{tool}: no CUDA device" in err
