"""PyTorch port vs. the JAX package: the packed row layouts (packed_colors'
i32x8 rows, packed_feats16's i32x4 rows), bf16 accumulation, the bf16
gradient tail and the whole "production" profile, on the CPU.

The JAX side runs its Pallas kernels in interpret mode (as its own tests do);
the port runs the plain versions of its CUDA kernels. Inputs are made from
numpy seeds and handed to both.

Tolerances, and why:
- packing and decoding: bit for bit. Both packages round half to even
  (jnp.round, torch.round; the f16 casts) and put the same fields into the
  same bits; the decode widens f16 exactly and scales the fixed-point
  fields by the same f32 steps.
- composite rows in a packed layout: atol 2e-5, the f32x16 contract of
  test_torch_composite.py (the decode is exact, so what differs is what
  differs there: the JAX kernel scans log(1 - w), the port multiplies).
- per-splat gradients in a packed layout: within 2e-4 of each column's
  largest magnitude, the contract of test_torch_composite_bwd.py.
- the bf16 tail: within 4e-3 of each column's largest gradient against the
  JAX package's bf16 tail. Both round every per-instance value to bf16 once;
  where the two packages' f32 instance values differ in their last bits, one
  rounding can land on the other side, which costs at most 2^-8 of that one
  instance's value. Against the port's own f32 tail: JAX's 1.5e-2
  (tests/test_tiled.py).
- bf16 accumulation: JAX's own 0.05 (tests/test_render.py), against JAX's
  bf16 render and against the port's f32 render. The port rounds the carried
  state once per 8-block segment where JAX rounds once per block.
- the production profile: image within 5e-4 of JAX's production render, and
  5 fit_scene losses within 1e-3 relative of JAX's. The bf16 tail and the
  20-bit depth key both go through rounding (ties in the key order the same
  way, but a rounding can fall differently on near-equal values), and the
  1/256 discard can flip at its edge.
"""

import concurrent.futures
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from splatapult_tpu.core import transforms as jT
from splatapult_tpu.io.gaussians import GaussianScene as JGaussianScene
from splatapult_tpu.io.gaussians import make_debug_scene as jmake_debug_scene
from splatapult_tpu.io.synth import garden_cameras as jgarden_cameras
from splatapult_tpu.io.synth import make_garden_scene as jmake_garden_scene
from splatapult_tpu.ops import binning as jb, composite as jc, tiled as jt
from splatapult_tpu.render import Camera as JCamera
from splatapult_tpu.render import RenderConfig as JRenderConfig
from splatapult_tpu.render import apply_profile as japply_profile
from splatapult_tpu.render import prepare_splats as jprepare_splats
from splatapult_tpu.render import render as jrender
from splatapult_tpu.train import fit_scene as jfit_scene

import splatapult_tpu_torch as st
from splatapult_tpu_torch import convert, train
from splatapult_tpu_torch.ops import binning as tb, composite as tc
from splatapult_tpu_torch.render import apply_profile

# One thread for torch: the suite runs several worker processes per machine,
# and an oversubscribed intra-op thread pool slows every worker down.
torch.set_num_threads(1)

JAX_FAST_COMPILE = {"xla_backend_optimization_level": 0}
N, W, H = 2000, 96, 64
GRID_KW = dict(width=W, height=H, num_splats=N, tile_size=16, block=8, max_instance_mult=4.0)
LAYOUTS = {"packed_colors": {"packed_colors": True}, "packed_feats16": {"packed_feats16": True}}


def _t(a):
    return torch.from_numpy(np.array(a))


def _torch_bins(jbins):
    return {k: _t(v) for k, v in jbins.items()}


def _close_by_column(got, want, rel, axis=0):
    """Every column within ``rel`` of its own largest magnitude."""
    scale = np.abs(want).max(axis=axis, keepdims=True)
    assert np.isfinite(got).all()
    err = np.abs(got - want) / np.maximum(scale, 1e-30)
    assert (np.abs(got - want) <= rel * scale + 1e-12).all(), err.max(axis=axis)


def _guard_band_feats(width, height, n=4096, seed=3):
    """Feature rows over the ranges a 1080p view puts into them: means across
    and beyond the guard band (some clip), conics down to f16 subnormals and
    up past the f16 range of qb, ln_alpha down to ln(1e-37), colours past
    both fixed-point ranges and on their rounding ties; the last row is the
    null row."""
    rng = np.random.default_rng(seed)
    f = np.zeros((n, tc.NUM_FEATS), np.float32)
    f[:, 0] = rng.uniform(-1.2 * width, 2.2 * width, n)
    f[:, 1] = rng.uniform(-1.2 * height, 2.2 * height, n)
    f[:, 2] = -np.exp(rng.uniform(-25.0, 1.0, n))  # subnormal f16 below 6.1e-5
    f[:, 3] = rng.uniform(-3.3, 3.3, n) * np.exp(rng.uniform(-20.0, 0.0, n))
    f[:, 4] = -np.exp(rng.uniform(-25.0, 1.0, n))
    f[:, 5] = rng.uniform(-85.2, 0.0, n)
    f[:, 6:9] = rng.uniform(-9.0, 9.0, (n, 3))
    f[:64, 6:9] = (np.round(f[:64, 6:9] * 4096) + 0.5) / 4096  # ties of the 2^-12 step
    f[64:128, 6:9] = (np.round(f[64:128, 6:9] * 256) + 0.5) / 256  # ties of the 2^-8 step
    f[-1] = 0.0
    f[-1, tc.F_LNA] = tc.NULL_LN_ALPHA
    return f


@pytest.mark.parametrize("size", [(1920, 1080), (W, H)], ids=["1080p", "96x64"])
def test_packing_bit_equal_to_jax(size):
    width, height = size
    f = _guard_band_feats(width, height)
    kw = dict(width=width, height=height, num_splats=64, tile_size=32, block=128)
    jgrid = jb.TileGrid.create(packed_feats16=True, **kw)
    grid = tb.TileGrid.create(packed_feats16=True, **kw)
    want16 = np.asarray(jc._pack_feats16(jnp.asarray(f), jgrid))
    got16 = tc.pack_feats16(torch.from_numpy(f), grid)
    assert got16.dtype == torch.int32 and got16.shape == (len(f), tc.NUM_FEATS_PACKED16)
    np.testing.assert_array_equal(got16.numpy(), want16)
    want8 = np.asarray(jc._pack_color_feats(jnp.asarray(f)))
    got8 = tc.pack_color_feats(torch.from_numpy(f))
    assert got8.dtype == torch.int32 and got8.shape == (len(f), tc.NUM_FEATS_PACKED)
    np.testing.assert_array_equal(got8.numpy(), want8)
    # pack_src picks the layout as the JAX package's _pack_src does
    for layout in ({}, {"packed_colors": True}, {"packed_feats16": True},
                   {"packed_colors": True, "packed_feats16": True}):
        g, jg = tb.TileGrid.create(**kw, **layout), jb.TileGrid.create(**kw, **layout)
        np.testing.assert_array_equal(tc.pack_src(torch.from_numpy(f), g).numpy(),
                                      np.asarray(jc._pack_src(jnp.asarray(f), jg)))
        assert tc.num_feats(g) == jc._num_feats(jg)
    # the null row survives both packings exactly
    for words, grid_ in ((got16, grid), (got8, tb.TileGrid.create(packed_colors=True, **kw))):
        geo, col = tc.unpack_feats(words[-1:], grid_)
        assert float(geo[0, 5]) == tc.NULL_LN_ALPHA and float(col.abs().max()) == 0.0


def test_decode_bit_equal_to_jax():
    """unpack_feats against _unpack_feats on arbitrary words: every 16-bit mean
    and colour field, and f16 patterns of every exponent but 31 (inf/NaN:
    no packed field holds one, the JAX integer decode does not read them as
    IEEE), subnormals and signed zeros included."""
    rng = np.random.default_rng(4)
    n = 65536
    kw = dict(width=1920, height=1080, num_splats=64, tile_size=32, block=128)
    halves = np.arange(n, dtype=np.int64)
    finite = halves[((halves >> 10) & 0x1F) != 31]
    w0 = (rng.permutation(n).astype(np.int64) << 16) | np.arange(n)
    f16 = rng.choice(finite, (n, 4))
    w1 = (f16[:, 0] << 16) | f16[:, 1]
    w2 = (f16[:, 2] << 16) | f16[:, 3]
    w3 = rng.integers(0, 2 ** 32, n, dtype=np.int64)
    w3[:2048] = np.arange(2048) * (2 ** 21 + 2 ** 10) + np.arange(2048) % 1024
    words16 = np.stack([w0, w1, w2, w3], 1)
    words16 = np.where(words16 >= 2 ** 31, words16 - 2 ** 32, words16).astype(np.int32)
    words8 = rng.integers(-2 ** 31, 2 ** 31, (n, 8), dtype=np.int64).astype(np.int32)
    words8[:, :6] = rng.standard_normal((n, 6)).astype(np.float32).view(np.int32)
    for words, knob in ((words16, "packed_feats16"), (words8, "packed_colors")):
        jgrid = jb.TileGrid.create(**kw, **{knob: True})
        grid = tb.TileGrid.create(**kw, **{knob: True})
        jgeo, jcol = jc._unpack_feats(jnp.asarray(words), jgrid)
        geo, col = tc.unpack_feats(torch.from_numpy(words), grid)
        assert geo.dtype == col.dtype == torch.float32
        np.testing.assert_array_equal(geo.contiguous().numpy().view(np.int32),
                                      np.asarray(jgeo)[:, :6].view(np.int32))
        np.testing.assert_array_equal(col.numpy().view(np.int32),
                                      np.asarray(jcol).view(np.int32))
    # f16 subnormals decode to their exact value (k * 2^-24)
    geo16, _ = tc.unpack_feats(torch.from_numpy(words16), tb.TileGrid.create(
        packed_feats16=True, **kw))
    sub = (f16[:, 0] & 0x7C00) == 0
    mag = (f16[:, 0] & 0x3FF).astype(np.float64) * 2.0 ** -24
    np.testing.assert_array_equal(np.abs(geo16[:, 2].numpy()[sub]), mag[sub])
    assert sub.sum() > 100


@pytest.mark.parametrize("layout", ["f32x16", "i32x8", "i32x4"])
def test_gather_rows_equals_row_indexing(layout):
    rng = np.random.default_rng(5)
    cols = {"f32x16": 16, "i32x8": 8, "i32x4": 4}[layout]
    src = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (300, cols), dtype=np.int64)
                           .astype(np.int32))
    if layout == "f32x16":
        src = src.view(torch.float32)
    idx = torch.from_numpy(rng.integers(0, 300, 1000))
    got = tc.gather_rows(src, idx)
    assert got.dtype == src.dtype and got.shape == (1000, cols)
    assert torch.equal(got.view(torch.int32), src[idx].view(torch.int32))


@functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
def _prepared_garden(scene):
    cam = jgarden_cameras(1, width=W, height_px=H)
    d = jprepare_splats(scene, cam, JRenderConfig(width=W, height=H), sort=False)
    feats = jt.pack_features(d["mean2d"], d["conic"], d["rgb"], d["alpha"])
    return feats, jb.bin_splats(d["mean2d"], d["extent"], jb.TileGrid.create(**GRID_KW),
                                depth=d["depth"])


# the knobs of every JAX composite vjp this file compares with
VJP_KNOBS = {**LAYOUTS, "bf16_tail": {"grad_sort_dtype": "bfloat16"}}


@pytest.fixture(scope="module")
def garden():
    """Prepared 2k-garden splats -> JAX feats and bins (one compiled program),
    and the JAX composite's rows and feats cotangent under each of VJP_KNOBS
    (one compiled program each, compiled in parallel while the next one is
    traced: tracing holds the GIL, XLA's compiling does not)."""
    feats, bins = jax.tree.map(np.asarray, _prepared_garden(jmake_garden_scene(N, seed=0)))
    dout = np.random.default_rng(9).standard_normal(
        (jb.TileGrid.create(**GRID_KW).num_tiles, 8, 256)).astype(np.float32)
    vjps = {}
    with concurrent.futures.ThreadPoolExecutor(len(VJP_KNOBS)) as pool:
        for name, knobs in VJP_KNOBS.items():
            jgrid = jb.TileGrid.create(**GRID_KW, **knobs)

            def rows_and_grad(f, bins, dout, jgrid=jgrid):
                out, vjp = jax.vjp(lambda f: jc.composite_from_feats(f, bins, jgrid), f)
                return out.astype(jnp.float32), vjp(dout.astype(out.dtype))[0]

            program = jax.jit(rows_and_grad, compiler_options=JAX_FAST_COMPILE)
            vjps[name] = pool.submit(program.lower(feats, bins, dout).compile)
        vjps = {name: jax.tree.map(np.asarray, exe.result()(feats, bins, dout))
                for name, exe in vjps.items()}
    return {"feats": feats, "bins": bins, "dout": dout, "jax_vjps": vjps}


def _vjp_both(garden, name):
    """JAX's and the port's composite rows and feats cotangent on the same
    inputs under VJP_KNOBS[name] -> (rows_port, rows_jax, grad_port,
    grad_jax, grid)."""
    grid = tb.TileGrid.create(**GRID_KW, **VJP_KNOBS[name])
    want_rows, want_grad = garden["jax_vjps"][name]
    feats = _t(garden["feats"]).requires_grad_(True)
    rows = tc.composite_from_feats(feats, _torch_bins(garden["bins"]), grid)
    rows.backward(_t(garden["dout"]).to(rows.dtype))
    return rows.detach(), want_rows, feats.grad.numpy(), want_grad, grid


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def layout_case(request, garden):
    return request.param, _vjp_both(garden, request.param)


def test_packed_forward_matches_jax(garden, layout_case):
    name, (rows, want, _, _, grid) = layout_case
    ok = np.asarray(garden["bins"]["tile_ok"])
    got = rows.numpy()
    assert rows.dtype == torch.float32 and got.shape == want.shape
    assert ok.sum() > grid.num_tiles // 2
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=2e-5)
    # the two passes of the CUDA forward, in plain PyTorch, on packed rows
    bins = _torch_bins(garden["bins"])
    inst = tc.pack_src(_t(garden["feats"]), grid)[bins["inst_splat"].long()]
    assert inst.dtype == torch.int32 and inst.shape == (grid.mcap, tc.num_feats(grid))
    start, nblk = tc.tile_block_ranges(bins["tile_count"], grid.block)
    locs = tc.composite_fwd_segments_plain(inst, start, nblk, grid)
    two_pass = tc.combine_segments_plain(locs, inst, start, nblk, grid).numpy()
    np.testing.assert_allclose(two_pass[ok], want[ok], rtol=0, atol=2e-5)


def test_packed_gradients_match_jax(garden, layout_case):
    name, (_, _, got, want, _) = layout_case
    assert got.shape == want.shape == (N + 1, tc.NUM_FEATS)
    assert np.abs(want[:, :9]).max(axis=0).min() > 0.0
    _close_by_column(got[:, :9], want[:, :9], 2e-4)
    assert (got[:, 9:] == 0).all() and (got[N] == 0).all()


def test_packed_rows_decode_like_the_quantized_exact_rows(garden, layout_case):
    """The packed forward is the exact forward on the decoded (quantized)
    features, bit for bit: the layout changes what is read, not the walk."""
    name, (rows, _, _, _, grid) = layout_case
    exact = tb.TileGrid.create(**GRID_KW)
    bins = _torch_bins(garden["bins"])
    geo, col = tc.unpack_feats(tc.pack_src(_t(garden["feats"]), grid), grid)
    quantized = torch.zeros((N + 1, tc.NUM_FEATS))
    quantized[:, :6], quantized[:, 6:9] = geo, col
    assert torch.equal(tc.composite_from_feats(quantized, bins, exact), rows)


@pytest.fixture(scope="module")
def bf16_tail(garden):
    return _vjp_both(garden, "bf16_tail")


def test_bf16_tail_matches_jax(bf16_tail):
    _, _, got, want, _ = bf16_tail
    _close_by_column(got[:, :9], want[:, :9], 4e-3)
    assert (got[:, 9:] == 0).all() and (got[N] == 0).all()


def test_bf16_tail_close_to_f32_tail(garden, bf16_tail):
    rows, _, got, _, grid = bf16_tail
    feats = _t(garden["feats"]).requires_grad_(True)
    f32_rows = tc.composite_from_feats(feats, _torch_bins(garden["bins"]),
                                       tb.TileGrid.create(**GRID_KW))
    assert torch.equal(f32_rows.detach(), rows)  # the tail does not touch the forward
    f32_rows.backward(_t(garden["dout"]))
    want = feats.grad.numpy()
    _close_by_column(got[:, :9], want[:, :9], 1.5e-2)
    assert not np.array_equal(got, want)  # the rounding did happen
    # only the per-instance values round: the columns of one instance are the
    # f32 columns rounded to bf16 and summed in f32
    bins = _torch_bins(garden["bins"])
    d_inst = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (9, grid.mcap)).astype(np.float32))
    d_inst[:, bins["inst_splat"] == N] = 0.0
    sums = [tc.per_splat_sums(x, bins["inst_splat"], bins["seg_offs"], bins["seg_cnt"], g)
            for x, g in ((d_inst, grid), (d_inst.bfloat16().float(), tb.TileGrid.create(**GRID_KW)))]
    assert torch.equal(sums[0], sums[1])


def test_bf16_backward_from_checkpoints_is_its_own_rounding(garden):
    """With bf16 accumulation the plain backward rounds (colour, T) at every
    segment boundary as the forward does; started from the forward's own
    checkpoints instead (as the CUDA kernel starts), it gives the same
    columns within 1e-6 of each column's scale (float association of S)."""
    grid = tb.TileGrid.create(accum_dtype="bfloat16", early_stop_eps=1e-4, **GRID_KW)
    bins = _torch_bins(garden["bins"])
    inst = _t(garden["feats"])[bins["inst_splat"].long()]
    start, nblk = tc.tile_block_ranges(bins["tile_count"], grid.block)
    assert int(nblk.max()) > tc.SEGMENT_BLOCKS
    out, seg = tc.composite_fwd_plain(inst, start, nblk, grid, checkpoints=True)
    assert out.dtype == torch.bfloat16
    dout = _t(garden["dout"]).to(torch.bfloat16)
    own = tc.composite_bwd_plain(inst, start, nblk, out, dout, grid).numpy()
    from_ckpt = tc.composite_bwd_plain(inst, start, nblk, out, dout, grid,
                                       segments=seg).numpy()
    _close_by_column(from_ckpt, own, 1e-6, axis=1)


@functools.partial(jax.jit, static_argnames="jcfg", compiler_options=JAX_FAST_COMPILE)
def _jrender_compiled(jscene, jcam, jcfg):
    return jrender(jscene, jcam, jcfg)


def _debug_case():
    jcam = JCamera.from_fov(
        jT.look_at(eye=[1.2, 1.1, 1.3], target=[0.3, 0.3, 0.3], up=[0, 1, 0]),
        fovy=np.pi / 4, width=64, height=64)
    jcfg = JRenderConfig(width=64, height=64, pipeline="tiled", tile_size=16, tile_block=8,
                         max_instance_mult=20)
    return jmake_debug_scene(), jcam, jcfg


def _port_side(jscene, jcam, jcfg):
    return (convert.scene_from_numpy(jscene, device="cpu"),
            convert.camera_from_numpy(np.asarray(jcam.cam_to_world), np.asarray(jcam.proj),
                                      device="cpu"),
            convert.config_from_jax(jcfg))


def test_bf16_accumulation_matches_jax():
    jscene, jcam, jcfg = _debug_case()
    jbf = dataclasses.replace(jcfg, accum_dtype="bfloat16")
    want = np.asarray(_jrender_compiled(jscene, jcam, jbf))
    scene, cam, cfg = _port_side(jscene, jcam, jbf)
    for name in ("means", "sh", "opacities"):
        getattr(scene, name).requires_grad_(True)
    img = st.render(scene, cam, cfg)
    assert img.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(img.detach().numpy(), want, atol=0.05)
    f32 = st.render(scene, cam, dataclasses.replace(cfg, accum_dtype="float32")).detach()
    np.testing.assert_allclose(img.detach().numpy(), f32.numpy(), atol=0.05)
    assert float(img.detach()[..., 3].max()) > 0.5 and not torch.equal(img.detach(), f32)
    # the rows themselves are bf16
    grid = tb.TileGrid.create(width=64, height=64, num_splats=16, tile_size=16, block=8,
                              max_instance_mult=20, accum_dtype="bfloat16")
    assert tc._rows(torch.rand(grid.num_tiles, 3, 256), torch.rand(grid.num_tiles, 256),
                    grid).dtype == torch.bfloat16
    torch.mean(img ** 2).backward()
    for name in ("means", "sh", "opacities"):
        g = getattr(scene, name).grad
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0.0, name


def test_production_render_matches_jax():
    jscene = jmake_garden_scene(N, seed=0)
    jcam = jgarden_cameras(1, width=W, height_px=H)
    jcfg = japply_profile(JRenderConfig(width=W, height=H, pipeline="tiled", tile_size=16,
                                        tile_block=8, max_instance_mult=4.0), "production")
    want = np.asarray(_jrender_compiled(jscene, jcam, jcfg))
    scene, cam, cfg = _port_side(jscene, jcam, jcfg)
    assert cfg == apply_profile(dataclasses.replace(cfg, packed_colors=False), "production")
    got = st.render(scene, cam, cfg).numpy()
    assert got[..., 3].max() > 0.5
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)


def test_production_fit_losses_match_jax():
    """Five fit_scene steps under the production profile: debug scene, two
    32 x 32 views, targets rendered by the JAX package (exact profile) from
    the true scene, the start a perturbed copy (as test_torch_train.py)."""
    true = jmake_debug_scene()
    exact = JRenderConfig(width=32, height=32, pipeline="tiled", tile_size=16, tile_block=8,
                          max_instance_mult=20)
    cams = [JCamera.from_fov(
        jT.look_at(eye=[np.cos(a) * 1.8, 1.0, np.sin(a) * 1.8], target=[0.3, 0.3, 0.3],
                   up=[0, 1, 0]), fovy=np.pi / 4, width=32, height=32)
        for a in np.linspace(0.3, 1.5, 2)]
    jcams = JCamera(cam_to_world=jnp.stack([c.cam_to_world for c in cams]),
                    proj=jnp.stack([c.proj for c in cams]))
    targets = jax.jit(lambda true, jcams: jnp.stack([
        jrender(true, JCamera(cam_to_world=m, proj=p), exact)
        for m, p in zip(jcams.cam_to_world, jcams.proj)]),
        compiler_options=JAX_FAST_COMPILE)(true, jcams)
    rng = np.random.default_rng(0)
    start = JGaussianScene(
        means=true.means + jnp.asarray(rng.normal(0, 0.03, (16, 3)), jnp.float32),
        sh=true.sh + jnp.asarray(rng.normal(0, 0.2, (16, 3, 16)), jnp.float32),
        opacities=true.opacities, log_scales=true.log_scales, quats=true.quats)
    jcfg = japply_profile(exact, "production")
    _, jlosses = jfit_scene(start, jcams, targets, jcfg, steps=5, learning_rate=2e-2)
    scene, tcams, cfg = _port_side(start, jcams, jcfg)
    _, losses = train.fit_scene(scene, tcams, np.asarray(targets), cfg, steps=5,
                                learning_rate=2e-2)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
