"""PyTorch port vs. the JAX package: stereo rendering with shared tile binning
(splatapult_tpu_torch/stereo.py against splatapult_tpu/stereo.py), on the CPU.

The JAX package's small config (64x64, tile 16, block 8, 48-96 random
splats; tests/test_stereo.py) with scenes made from numpy seeds and handed to
both packages (convert.py). The JAX references come from two compiled
programs in a module fixture (the gradients compiled in a thread while the
forward program is traced), with XLA's backend optimisations off
(JAX_FAST_COMPILE), as tests/test_torch_global.py builds its own.

Tolerances, and why:
- the union rects and every array of the bins: bit for bit on the same
  inputs (the JAX package's per-eye mean2d / extent and left-eye depth; the
  two packages' projections differ in the last bits, so the end-to-end rects
  are compared through what they decide instead). The demand and the
  calibrated max_instance_mult end to end: equal (integers, and the mult is
  a function of the demand).
- images: atol 3e-5 under the exact profile, as the tiled render
  (test_torch_render.py); 5e-4 under the production profile and with
  packed_feats16, as test_torch_packed.py (the 20-bit key and the colour
  rounding go through rounding, and the 1/256 discard can flip at its edge).
- a shared-bins eye against the port's own render of that eye: 2e-5, the
  JAX package's own contract (tests/test_stereo.py): the segments fall
  elsewhere in longer chains, which changes only the float association.
- gradients of mean(render_stereo ** 2): each field within 2e-4 of that
  field's largest gradient, as test_torch_train.py; the loss rtol 1e-5.
- a splat culled in one eye gets exactly zero gradient from that eye.
"""

import concurrent.futures
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from splatapult_tpu import stereo as jstereo
from splatapult_tpu.io.gaussians import GaussianScene as JGaussianScene
from splatapult_tpu.ops import binning as jb
from splatapult_tpu.ops.tiled import _grid_from_config as jgrid_from_config
from splatapult_tpu.render import CAPACITY_BUCKET as JCAPACITY_BUCKET
from splatapult_tpu.render import Camera as JCamera
from splatapult_tpu.render import RenderConfig as JRenderConfig
from splatapult_tpu.render import apply_profile as japply_profile
from splatapult_tpu.render import capacity_mult_for_demand as jcapacity_mult_for_demand

import splatapult_tpu_torch as st
from splatapult_tpu_torch import convert, stereo
from splatapult_tpu_torch.core import transforms as tT
from splatapult_tpu_torch.ops import binning as tb
from splatapult_tpu_torch.ops.tiled import _grid_from_config
from splatapult_tpu_torch.render import prepare_splats

# One thread for torch: the suite runs several worker processes per machine,
# and an oversubscribed intra-op thread pool slows every worker down.
torch.set_num_threads(1)

JAX_FAST_COMPILE = {"xla_backend_optimization_level": 0}
FIELDS = ("means", "sh", "opacities", "log_scales", "quats")
BINS_COMPARED = ("inst_splat", "block_meta", "seg_offs", "seg_cnt", "block_tile",
                 "block_first", "block_live", "tile_ok", "tile_count", "num_culled_instances")
CFG = JRenderConfig(width=64, height=64, pipeline="tiled", tile_size=16, tile_block=8,
                    max_instance_mult=40)
PROFILE_CFGS = {
    "production": japply_profile(CFG, "production"),
    "packed_feats16": dataclasses.replace(japply_profile(CFG, "production"), packed_feats16=True),
}
PROJ = tT.perspective(np.pi / 4, 1.0, 0.1, 1000.0)
# (scene seed, spread, eye, ipd), 96 splats each: the JAX tests' view at two
# ipds, and a close camera with a large ipd where splats cull in one eye only
CASES = {
    "ipd_0.064": (0, 0.8, (1.2, 1.1, 1.3), 0.064),
    "ipd_0.4": (0, 0.8, (1.2, 1.1, 1.3), 0.4),
    "close": (1, 1.2, (0.9, 0.6, 0.9), 0.5),
}
GRAD_CASE = (2, 0.8, (1.2, 1.1, 1.3), 0.1)  # 48 splats


def _scene_arrays(seed, n, spread):
    rng = np.random.default_rng(seed)
    quats = rng.standard_normal((n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    return {"means": rng.uniform(-spread, spread, (n, 3)).astype(np.float32),
            "sh": (rng.standard_normal((n, 3, 1)) * 0.5).astype(np.float32),
            "opacities": rng.uniform(-1.0, 2.5, (n,)).astype(np.float32),
            "log_scales": rng.uniform(-3.5, -1.5, (n, 3)).astype(np.float32),
            "quats": quats}


def _camera(eye):
    """-> (camera-to-world, projection) numpy arrays, made once and handed to
    both packages."""
    return tT.look_at(eye=list(eye), target=[0.3, 0.3, 0.3], up=[0.0, 1.0, 0.0]), PROJ


def _jscene(arrays):
    return JGaussianScene(**{f: jnp.asarray(a) for f, a in arrays.items()})


def _port(arrays, cam, jcfg=CFG):
    return (convert.scene_from_numpy(arrays, device="cpu"),
            convert.camera_from_numpy(*cam, device="cpu"), convert.config_from_jax(jcfg))


@pytest.fixture(scope="module")
def ref():
    """Every JAX reference of this file, from two compiled programs:
    - per case of CASES (one body under lax.map: the cases share their
      shapes): the per-eye prepared dicts, the union rects, the bins of the
      union, the union demand and render_stereo; render_stereo of the
      "ipd_0.064" case under each of PROFILE_CFGS; the eye cameras of the
      "ipd_0.4" case;
    - "grads": jax.value_and_grad of mean(render_stereo ** 2) for GRAD_CASE."""
    arrays = {k: _scene_arrays(seed, 96, spread) for k, (seed, spread, _, _) in CASES.items()}
    cams = {k: _camera(eye) for k, (_, _, eye, _) in CASES.items()}
    cases = (jax.tree.map(lambda *a: jnp.stack(a), *map(_jscene, arrays.values())),
             jnp.stack([c[0] for c in cams.values()]), jnp.stack([c[1] for c in cams.values()]),
             jnp.asarray([ipd for _, _, _, ipd in CASES.values()], jnp.float32))
    grad_arrays, grad_cam = _scene_arrays(GRAD_CASE[0], 48, GRAD_CASE[1]), _camera(GRAD_CASE[2])

    def case(x):
        s, c2w, proj, ipd = x
        cam = JCamera(cam_to_world=c2w, proj=proj)
        d_l, d_r, um, ue = jstereo.stereo_prepare(s, cam, CFG, ipd)
        return {"d_l": d_l, "d_r": d_r, "union": (um, ue),
                "bins": jb.bin_splats(um, ue, jgrid_from_config(CFG, um.shape[0]),
                                      depth=d_l["depth"]),
                "demand": jstereo.stereo_instance_demand(s, cam, CFG, ipd),
                "image": jstereo.render_stereo(s, cam, CFG, ipd)}

    @functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
    def forward(cases):
        s, c2w, proj, ipd = jax.tree.map(lambda a: a[0], cases)
        cam = JCamera(cam_to_world=c2w, proj=proj)
        return {"cases": jax.lax.map(case, cases),
                "profiles": {p: jstereo.render_stereo(s, cam, c, ipd)
                             for p, c in PROFILE_CFGS.items()},
                "eye_cameras": jstereo._eye_cameras(
                    JCamera(cam_to_world=cases[1][1], proj=cases[2][1]), 0.4)}

    @functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
    def grads(scene, c2w, proj):
        cam = JCamera(cam_to_world=c2w, proj=proj)
        return jax.value_and_grad(
            lambda s: jnp.mean(jstereo.render_stereo(s, cam, CFG, GRAD_CASE[3]) ** 2))(scene)

    # tracing holds the GIL, XLA's compiling does not: each program compiles
    # in a thread while the next one is traced
    grad_args = (_jscene(grad_arrays), *map(jnp.asarray, grad_cam))
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        forward_exe = pool.submit(forward.lower(cases).compile)
        grads_exe = pool.submit(grads.lower(*grad_args).compile)
        out = jax.tree.map(np.asarray, forward_exe.result()(cases))
        loss, g = grads_exe.result()(*grad_args)
    by_case = out.pop("cases")
    for i, k in enumerate(CASES):
        out[k] = {**jax.tree.map(lambda a: a[i], by_case), "arrays": arrays[k], "cam": cams[k],
                  "ipd": CASES[k][3]}
    out["grads"] = (grad_arrays, grad_cam, GRAD_CASE[3], float(loss),
                    {f: np.asarray(getattr(g, f)) for f in FIELDS})
    return out


def test_eye_cameras_match_jax(ref):
    cam = convert.camera_from_numpy(*ref["ipd_0.4"]["cam"], device="cpu")
    for got, want in zip(stereo._eye_cameras(cam, 0.4), ref["eye_cameras"]):
        assert got.cam_to_world.shape == got.proj.shape == (4, 4)
        np.testing.assert_allclose(got.cam_to_world.numpy(), want.cam_to_world,
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got.proj.numpy(), want.proj)


def test_interval_union_bit_for_bit():
    """Every case of the rule: both live (overlapping, disjoint, nested), one
    empty (r <= 0 on either side, negative r too), both empty -> (0, 0), and
    centres far out where the sentinels would show if they leaked."""
    rng = np.random.default_rng(3)
    n = 4096
    c_a, c_b = (rng.uniform(-200.0, 260.0, n).astype(np.float32) for _ in range(2))
    r_a, r_b = (rng.uniform(-5.0, 40.0, n).astype(np.float32) for _ in range(2))
    r_a[::7], r_b[::5] = 0.0, 0.0
    c_a[::11] = np.float32(1e30)
    c_b[::13] = np.float32(-1e30)
    got = stereo._interval_union(*map(torch.from_numpy, (c_a, r_a, c_b, r_b)))
    want = jstereo._interval_union(*map(jnp.asarray, (c_a, r_a, c_b, r_b)))
    both_empty = (r_a <= 0) & (r_b <= 0)
    assert both_empty.sum() > 50 and ((r_a > 0) ^ (r_b > 0)).sum() > 500
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy().view(np.int32), np.asarray(b).view(np.int32))
        assert (a.numpy()[both_empty] == 0.0).all()


@pytest.mark.parametrize("case", list(CASES))
def test_union_rects_and_bins_bit_for_bit(ref, case):
    r = ref[case]
    ds = [{k: torch.from_numpy(v[k]) for k in ("mean2d", "extent")} for v in (r["d_l"], r["d_r"])]
    um, ue = stereo.union_rects(ds)
    np.testing.assert_array_equal(um.numpy().view(np.int32), r["union"][0].view(np.int32))
    np.testing.assert_array_equal(ue.numpy().view(np.int32), r["union"][1].view(np.int32))
    grid = _grid_from_config(convert.config_from_jax(CFG), um.shape[0])
    bins = tb.bin_splats(um, ue, grid, depth=torch.from_numpy(r["d_l"]["depth"]))
    for k in BINS_COMPARED:
        a, b = bins[k].numpy(), r["bins"][k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert int(bins["num_culled_instances"]) == 0 and int(bins["tile_count"].sum()) > 0
    if case == "close":  # splats culled in exactly one eye ride the shared lists
        one_eye = r["d_l"]["mask"] != r["d_r"]["mask"]
        assert one_eye.sum() > 5 and (bins["seg_cnt"].numpy()[one_eye] > 0).sum() > 5


@pytest.mark.parametrize("case", list(CASES))
def test_demand_and_calibration_match_jax(ref, case):
    r = ref[case]
    scene, cam, cfg = _port(r["arrays"], r["cam"])
    ipd, want = r["ipd"], int(r["demand"])
    assert int(stereo.stereo_instance_demand(scene, cam, cfg, ipd)) == want
    # a single eye's demand is below the union's
    left = stereo._eye_cameras(cam, ipd)[0]
    d = prepare_splats(scene, left, cfg, sort=False)
    assert int(tb.instance_demand(d["mean2d"], d["extent"],
                                  _grid_from_config(cfg, scene.num_gaussians))) <= want
    # calibrate_config_stereo is capacity_mult_for_demand of that demand
    small = dataclasses.replace(cfg, max_instance_mult=0.01)
    cal = stereo.calibrate_config_stereo(scene, cam, small, ipd)
    jsmall = dataclasses.replace(CFG, max_instance_mult=0.01)
    assert cal.max_instance_mult == jcapacity_mult_for_demand(
        want, scene.num_gaussians, jsmall, 1.06, JCAPACITY_BUCKET)
    assert cal.max_instance_mult > small.max_instance_mult


@pytest.mark.parametrize("case", list(CASES))
def test_render_stereo_matches_jax(ref, case):
    r = ref[case]
    want = r["image"]
    got = stereo.render_stereo(*_port(r["arrays"], r["cam"]), r["ipd"])
    assert got.shape == want.shape == (2, 64, 64, 4) and want[..., 3].max() > 0.5
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-5)


@pytest.mark.parametrize("profile", list(PROFILE_CFGS))
def test_render_stereo_profiles_match_jax(ref, profile):
    r, want = ref["ipd_0.064"], ref["profiles"][profile]
    got = stereo.render_stereo(*_port(r["arrays"], r["cam"], PROFILE_CFGS[profile]), r["ipd"])
    assert got.shape == (2, 64, 64, 4) and want[..., 3].max() > 0.5
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-4)


@pytest.mark.parametrize("case", ["ipd_0.4", "close"])
def test_each_eye_equals_its_own_render(ref, case):
    """The exactness argument on the port alone: each shared-bins eye equals
    render() of that eye (per-eye binning), culled-in-one-eye splats and all;
    forward_only changes no bit."""
    ipd = ref[case]["ipd"]
    scene, cam, cfg = _port(ref[case]["arrays"], ref[case]["cam"])
    got = stereo.render_stereo(scene, cam, cfg, ipd)
    for e, eye in enumerate(stereo._eye_cameras(cam, ipd)):
        np.testing.assert_allclose(got[e].numpy(), st.render(scene, eye, cfg).numpy(),
                                   rtol=0, atol=2e-5)
    fwd = stereo.render_stereo(scene, cam, dataclasses.replace(cfg, forward_only=True), ipd)
    assert torch.equal(fwd, got)


def test_render_stereo_gradients_match_jax(ref):
    arrays, jcam, ipd, want_loss, want = ref["grads"]
    scene, cam, cfg = _port(arrays, jcam)
    for f in FIELDS:
        getattr(scene, f).requires_grad_(True)
    loss = torch.mean(stereo.render_stereo(scene, cam, cfg, ipd) ** 2)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    for f, w in want.items():
        got = getattr(scene, f).grad.numpy()
        scale = np.abs(w).max()
        assert scale > 0.0 and np.isfinite(got).all(), f
        assert np.abs(got - w).max() / scale <= 2e-4, (f, np.abs(got - w).max() / scale)


def test_culled_eye_gives_exactly_zero_gradient(ref):
    """A splat culled in the left eye but live in the right rides the shared
    lists; the left eye's image alone gives it exactly zero gradient in every
    field, and the right eye's a non-zero one."""
    arrays, ipd = ref["close"]["arrays"], ref["close"]["ipd"]
    m_l, m_r = ref["close"]["d_l"]["mask"], ref["close"]["d_r"]["mask"]
    only_right = ~m_l & m_r
    assert only_right.sum() > 2
    grads = []
    for e in (0, 1):
        scene, cam, cfg = _port(arrays, ref["close"]["cam"])
        for f in FIELDS:
            getattr(scene, f).requires_grad_(True)
        torch.mean(stereo.render_stereo(scene, cam, cfg, ipd)[e] ** 2).backward()
        grads.append({f: getattr(scene, f).grad.numpy() for f in FIELDS})
    for f in FIELDS:
        assert (grads[0][f][only_right] == 0.0).all(), f
        assert np.isfinite(grads[0][f]).all() and np.isfinite(grads[1][f]).all(), f
    assert np.abs(grads[1]["opacities"][only_right]).max() > 0.0


@pytest.mark.parametrize("fn", ["render_stereo", "calibrate_config_stereo"])
def test_supersample_raises(fn):
    """The JAX package builds the grid at the output size and ignores
    supersample here (ROADMAP queue 3); the port refuses the config."""
    scene, cam, cfg = _port(_scene_arrays(0, 16, 0.8), _camera((1.2, 1.1, 1.3)))
    ipd = 0.064
    with pytest.raises(ValueError, match="supersample"):
        getattr(stereo, fn)(scene, cam, dataclasses.replace(cfg, supersample=2), ipd)
