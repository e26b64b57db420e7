"""PyTorch port vs. the JAX package: the global pipeline (prepare_splats with
the front-to-back sort, the blockwise whole-image composite and its
gradients), supersampling, render_batch and Camera.stereo_pair, on the CPU.

Scenes are small (the 16-splat debug scene, tests/test_grads.py's scene, a
3000-splat garden) at 48x32 or smaller. The JAX references are built in
module-scoped fixtures, several in one compiled program, with XLA's backend
optimisations off (JAX_FAST_COMPILE): compiling is what these tests spend
their time on, and the results differ from an optimised build only in
float32 rounding.

Tolerances. Sort order and the permutation's backward: bit for bit (the same
keys sort the same; a gather is exact). Sorted rows: rtol/atol 1e-5, as
prepare in test_torch_prepare.py. Images, f32: atol 3e-5, as the tiled
render (cumprod and the [P, B] x [B, 3] product round as XLA's do, to ~1e-6).
Block-size invariance: 1e-5, as tests/test_render.py. bf16 accumulation: the
carry and the colour product are bf16 on both sides, and the two backends
round the product's sum differently; measured max 7.8e-3 (one bf16 step at
1.0 is 3.9e-3) on the garden view, held to 1.6e-2 (JAX's bf16 contract is
0.05). Gradients: each field within 2e-4 of that field's largest gradient, as
tests/test_torch_train.py. Supersample: atol 3e-5 against JAX, 1e-6 against
the port's own hi-res render + box filter. Stereo cameras: 1e-6.
"""

import concurrent.futures
import dataclasses
import functools
import importlib

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
from splatapult_tpu.render import Camera as JCamera
from splatapult_tpu.render import RenderConfig as JRenderConfig
from splatapult_tpu.render import prepare_splats as jprepare_splats
from splatapult_tpu.render import render as jrender
from splatapult_tpu.render import render_batch as jrender_batch

import splatapult_tpu_torch as st
from splatapult_tpu_torch import convert
from splatapult_tpu_torch.core import transforms as tT
from splatapult_tpu_torch.io.gaussians import make_debug_scene
from splatapult_tpu_torch.ops.binning import TileGrid, instance_demand
from splatapult_tpu_torch.ops.tiled import composite_tiled

# One thread for torch: the suite runs several worker processes per machine,
# and an oversubscribed intra-op thread pool slows every worker down.
torch.set_num_threads(1)

R = importlib.import_module("splatapult_tpu_torch.render")  # the package re-exports render()
FIELDS = ("means", "sh", "opacities", "log_scales", "quats")
GRAD_REL_TOL = 2e-4
JAX_FAST_COMPILE = {"xla_backend_optimization_level": 0}


def _port_side(jscene, jcam, jcfg):
    return (convert.scene_from_numpy(jscene, device="cpu"),
            convert.camera_from_numpy(np.asarray(jcam.cam_to_world), np.asarray(jcam.proj),
                                      device="cpu"),
            convert.config_from_jax(jcfg))


def _debug_camera(width, height, eye=(1.2, 1.1, 1.3)):
    return JCamera.from_fov(jT.look_at(eye=list(eye), target=[0.3, 0.3, 0.3], up=[0, 1, 0]),
                            fovy=np.pi / 4, width=width, height=height)


# the garden view's JAX renders, by name
GARDEN_CFGS = {
    "cutoff": JRenderConfig(width=48, height=32, pipeline="global"),
    "no_cutoff": JRenderConfig(width=48, height=32, pipeline="global", alpha_cutoff=0.0),
    "bf16": JRenderConfig(width=48, height=32, pipeline="global", accum_dtype="bfloat16"),
    "supersample": JRenderConfig(width=24, height=16, pipeline="global", supersample=2),
}
GRAD_CUTOFFS = {"no_cutoff": 0.0, "cutoff": 1.0 / 256.0}
BATCH_CFG = JRenderConfig(32, 32, pipeline="global")


def _grads_scene():
    """tests/test_grads.py's scene: the debug scene with opacity 0.5,
    anisotropic scales and rotated quats (made in numpy)."""
    scene = jmake_debug_scene()
    rng = np.random.default_rng(11)
    quats = rng.standard_normal(scene.quats.shape).astype(np.float32)
    return JGaussianScene(
        means=scene.means, sh=scene.sh, opacities=jnp.full(scene.opacities.shape, 0.5),
        log_scales=jnp.asarray(np.asarray(scene.log_scales) + rng.uniform(
            -0.5, 0.5, scene.log_scales.shape).astype(np.float32)),
        quats=jnp.asarray(quats / np.linalg.norm(quats, axis=-1, keepdims=True)))


def _grads_camera():
    return JCamera.from_fov(
        jT.look_at(eye=[1.0, 0.9, 1.1], target=[0.25, 0.25, 0.25], up=[0, 1, 0]),
        fovy=np.pi / 4, width=32, height=32)


def _grads_config(case):
    return JRenderConfig(width=32, height=32, pipeline="global", block_size=8,
                         alpha_cutoff=GRAD_CUTOFFS[case])


_TAN = float(np.tan(np.pi / 8))
STEREO_CASES = {
    "symmetric": {},
    "asymmetric": dict(tan_angles=np.asarray([[-1.3 * _TAN, 0.8 * _TAN, _TAN, -_TAN],
                                              [-0.8 * _TAN, 1.3 * _TAN, _TAN, -_TAN]],
                                             np.float32), near=0.1, far=1000.0),
    "infinite_far": dict(tan_angles=np.asarray([[-_TAN, _TAN, _TAN, -_TAN]] * 2, np.float32),
                         near=0.1, far=0.0),
}


def _batch_cameras():
    cams = [JCamera.from_fov(
        jT.look_at(eye=[np.cos(a) * 2, 1.0, np.sin(a) * 2], target=[0, 0, 0], up=[0, 1, 0]),
        fovy=np.pi / 4, width=32, height=32) for a in (0.0, 1.0, 2.0)]
    return JCamera(cam_to_world=jnp.stack([c.cam_to_world for c in cams]),
                   proj=jnp.stack([c.proj for c in cams]))


@pytest.fixture(scope="module")
def ref():
    """Every JAX reference of this file, from two compiled programs, the one
    compiled while the other is traced (the cameras are built inside them,
    so nothing is dispatched one operation at a time):
    - "garden": a 3000-splat garden and one 48x32 view (about half the
      splats culled), its renders under GARDEN_CFGS ("images") and its
      sorted prepare ("prepared");
    - "batch": render_batch of the debug scene from three cameras;
    - "stereo": Camera.stereo_pair of one debug camera ("stereo_cam") for
      each of STEREO_CASES;
    - "grads": jax.value_and_grad of an L2 loss on tests/test_grads.py's
      scene for both GRAD_CUTOFFS -> {case: (loss, {field: grad})}, and its
      camera ("grads_cam")."""
    garden_scene, debug = jmake_garden_scene(3000, seed=0), jmake_debug_scene()
    grads_scene = _grads_scene()
    target = np.random.default_rng(7).uniform(size=(32, 32, 4)).astype(np.float32)

    @functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
    def forward(garden_scene, debug):
        cam, batch = jgarden_cameras(1, width=48, height_px=32), _batch_cameras()
        stereo_cam = _debug_camera(64, 48)
        return {"images": {k: jrender(garden_scene, cam, cfg) for k, cfg in GARDEN_CFGS.items()},
                "prepared": jprepare_splats(garden_scene, cam, GARDEN_CFGS["cutoff"], sort=True),
                "prepared_default": jprepare_splats(garden_scene, cam, GARDEN_CFGS["cutoff"]),
                "batch": jrender_batch(debug, batch, BATCH_CFG), "cam": cam, "batch_cams": batch,
                "stereo": {case: stereo_cam.stereo_pair(0.2, **kwargs)
                           for case, kwargs in STEREO_CASES.items()},
                "stereo_cam": stereo_cam}

    @functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
    def grads(scene):
        cam = _grads_camera()
        return cam, {case: jax.value_and_grad(lambda s: jnp.mean(
                         (jrender(s, cam, _grads_config(case)) - target) ** 2))(scene)
                     for case in GRAD_CUTOFFS}

    # XLA compiles the grads program in a second thread while this one
    # traces the forward program (tracing holds the GIL, compiling does not)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        grads_exe = pool.submit(grads.lower(grads_scene).compile)
        out = jax.tree.map(np.asarray, forward(garden_scene, debug))
        grads_cam, by_case = grads_exe.result()(grads_scene)
    out["grads"] = {case: (float(loss), {f: np.asarray(getattr(g, f)) for f in FIELDS})
                    for case, (loss, g) in by_case.items()}
    return {**out, "garden": (garden_scene, out["cam"]), "batch_inputs": (debug, out["batch_cams"]),
            "grads_scene": grads_scene, "grads_cam": grads_cam, "target": target}


def _jax_order(depth, mask):
    key = jnp.where(mask, depth, jnp.inf)
    idx = jnp.arange(key.shape[0], dtype=jnp.int32)
    return np.asarray(jax.lax.sort((key, -idx, idx), num_keys=2)[2])


def test_front_to_back_order_is_jax_order_bit_for_bit(ref):
    jscene, jcam = ref["garden"]
    scene, cam, cfg = _port_side(jscene, jcam, GARDEN_CFGS["cutoff"])
    d = R.prepare_splats(scene, cam, cfg, sort=False)
    depth, mask = d["depth"].detach(), d["mask"]
    # ties: depths rounded to a coarse grid, so many keys are equal
    tied = torch.round(depth * 4.0) / 4.0
    for dep in (depth, tied):
        order, inv = R._front_to_back_order(dep, mask)
        want = _jax_order(jnp.asarray(dep.numpy()), jnp.asarray(mask.numpy()))
        np.testing.assert_array_equal(order.numpy(), want)
        np.testing.assert_array_equal(inv.numpy()[want], np.arange(len(want)))
    assert len(torch.unique(tied[mask])) < int(mask.sum()) // 4
    assert 0 < int(mask.sum()) < len(mask)


def test_prepare_defaults_to_the_jax_sorted_order(ref):
    """prepare_splats with no ``sort`` argument: the JAX call with none, which
    sorts; the port's rows are its sort=True rows bit for bit."""
    (jscene, jcam), want = ref["garden"], ref["prepared_default"]
    scene, cam, cfg = _port_side(jscene, jcam, GARDEN_CFGS["cutoff"])
    got = R.prepare_splats(scene, cam, cfg)
    sorted_ = R.prepare_splats(scene, cam, cfg, sort=True)
    assert set(got) == set(want) == set(sorted_)
    for k in got:
        assert torch.equal(got[k], sorted_[k]), k
    mask = want["mask"]
    np.testing.assert_array_equal(got["mask"].numpy(), mask)
    np.testing.assert_array_equal(want["depth"], ref["prepared"]["depth"])
    np.testing.assert_allclose(got["depth"].numpy()[mask], want["depth"][mask], rtol=1e-5,
                               atol=1e-5)
    assert np.all(np.diff(got["depth"].numpy()[mask]) >= 0)


def test_prepare_sorted_matches_jax(ref):
    (jscene, jcam), want = ref["garden"], ref["prepared"]
    scene, cam, cfg = _port_side(jscene, jcam, GARDEN_CFGS["cutoff"])
    got = R.prepare_splats(scene, cam, cfg, sort=True)
    assert set(got) == set(want)
    mask = want["mask"]
    np.testing.assert_array_equal(got["mask"].numpy(), mask)
    assert mask[:mask.sum()].all() and not mask[mask.sum():].any()  # culled at the back
    for k in ("rgb", "alpha", "radius", "extent"):
        np.testing.assert_allclose(got[k].detach().numpy(), want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    for k in ("mean2d", "conic", "depth"):
        np.testing.assert_allclose(got[k].detach().numpy()[mask], want[k][mask],
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_permute_rows_backward_is_the_inverse_gather():
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((300, 14), generator=gen, requires_grad=True)
    order = torch.randperm(300, generator=gen)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(300)
    g = torch.randn((300, 14), generator=gen)
    out = R._PermuteRows.apply(x, order, inv)
    assert torch.equal(out, x.detach()[order])
    out.backward(g)
    assert torch.equal(x.grad, g[inv])


@pytest.mark.parametrize("case", ["cutoff", "no_cutoff"])
def test_global_render_matches_jax(ref, case):
    (jscene, jcam), want = ref["garden"], ref["images"]
    got = st.render(*_port_side(jscene, jcam, GARDEN_CFGS[case])).numpy()
    assert got.shape == (32, 48, 4) and want[case][..., 3].max() > 0.5
    np.testing.assert_allclose(got, want[case], rtol=0, atol=3e-5)


def test_global_block_size_invariance():
    scene = make_debug_scene(device="cpu")
    cam = st.Camera.from_fov(tT.look_at(eye=[1.2, 1.1, 1.3], target=[0.3, 0.3, 0.3], up=[0, 1, 0]),
                             fovy=np.pi / 4, width=64, height=64, device="cpu")
    imgs = [st.render(scene, cam, st.RenderConfig(64, 64, pipeline="global", block_size=b))
            for b in (1, 4, 16)]
    assert float(imgs[0][..., 3].max()) > 0.5
    np.testing.assert_allclose(imgs[0].numpy(), imgs[1].numpy(), atol=1e-5)
    np.testing.assert_allclose(imgs[1].numpy(), imgs[2].numpy(), atol=1e-5)


def test_global_bf16_accumulation_matches_jax(ref):
    (jscene, jcam), want = ref["garden"], ref["images"]
    scene, cam, cfg = _port_side(jscene, jcam, GARDEN_CFGS["bf16"])
    got = st.render(scene, cam, cfg).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want["bf16"], rtol=0, atol=1.6e-2)
    # and it stays within JAX's bf16 contract of the f32 render
    f32 = st.render(scene, cam, dataclasses.replace(cfg, accum_dtype="float32"))
    np.testing.assert_allclose(got, f32.numpy(), rtol=0, atol=0.05)


@pytest.mark.parametrize("case", list(GRAD_CUTOFFS))
def test_global_gradients_match_jax(ref, case):
    want_loss, want = ref["grads"][case]
    scene, cam, cfg = _port_side(ref["grads_scene"], ref["grads_cam"], _grads_config(case))
    for f in FIELDS:
        getattr(scene, f).requires_grad_(True)
    loss = torch.mean((st.render(scene, cam, cfg) - torch.from_numpy(ref["target"])) ** 2)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    for f, w in want.items():
        got = getattr(scene, f).grad.numpy()
        scale = np.abs(w).max()
        assert scale > 0.0 and np.isfinite(got).all(), f
        err = np.abs(got - w).max() / scale
        assert err <= GRAD_REL_TOL, (f, err)


def test_supersample_matches_jax_and_box_filter(ref):
    (jscene, jcam), want = ref["garden"], ref["images"]
    scene, cam, cfg = _port_side(jscene, jcam, GARDEN_CFGS["supersample"])
    got = st.render(scene, cam, cfg)
    assert got.shape == (16, 24, 4) and want["supersample"][..., 3].max() > 0.5
    np.testing.assert_allclose(got.numpy(), want["supersample"], rtol=0, atol=3e-5)
    hi = st.render(scene, cam, dataclasses.replace(cfg, supersample=1, width=48, height=32))
    np.testing.assert_allclose(got.numpy(), hi.reshape(16, 2, 24, 2, 4).mean(dim=(1, 3)).numpy(),
                               rtol=0, atol=1e-6)


def test_render_batch_matches_jax(ref):
    want = ref["batch"]
    scene, batch, cfg = _port_side(*ref["batch_inputs"], BATCH_CFG)
    got = R.render_batch(scene, batch, cfg)
    assert got.shape == (3, 32, 32, 4) and np.abs(want[0] - want[1]).max() > 1e-3
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-5)
    for v in range(3):  # each view is render() of that camera alone
        one = st.render(scene, st.Camera(batch.cam_to_world[v], batch.proj[v]), cfg)
        assert torch.equal(got[v], one)


@pytest.mark.parametrize("case", list(STEREO_CASES))
def test_stereo_pair_matches_jax(ref, case):
    jcam, want = ref["stereo_cam"], ref["stereo"][case]
    cam = convert.camera_from_numpy(jcam.cam_to_world, jcam.proj, device="cpu")
    got = cam.stereo_pair(0.2, **STEREO_CASES[case])
    assert got.cam_to_world.shape == got.proj.shape == (2, 4, 4)
    np.testing.assert_allclose(got.cam_to_world.numpy(), want.cam_to_world, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.proj.numpy(), want.proj, rtol=0, atol=1e-6)
    sep = got.cam_to_world[1, :3, 3] - got.cam_to_world[0, :3, 3]
    np.testing.assert_allclose(float(torch.linalg.vector_norm(sep)), 0.2, rtol=1e-5)


def test_calibrated_supersample_drops_no_instance():
    """calibrate_config sizes a supersampled render's capacity at the rendered
    size: no instance is dropped where a capacity sized at the output size is
    smaller than what the rendered image needs (the JAX package's fault,
    ROADMAP queue 3). 3000 random splats a few pixels wide, so a splat covers
    more tiles at twice the size."""
    rng = np.random.default_rng(5)
    n = 3000
    quats = rng.standard_normal((n, 4))
    scene = convert.scene_from_numpy(dict(
        means=rng.uniform(-1, 1, (n, 3)), sh=rng.standard_normal((n, 3, 1)) * 0.5,
        opacities=rng.uniform(0, 3, n), log_scales=rng.uniform(-3.5, -2.5, (n, 3)),
        quats=quats / np.linalg.norm(quats, axis=-1, keepdims=True)), device="cpu")
    cam = st.Camera.from_fov(tT.look_at(eye=[0, 0.5, 3.0], target=[0, 0, 0], up=[0, 1, 0]),
                             fovy=np.pi / 4, width=64, height=48, device="cpu")
    cfg = st.RenderConfig(width=64, height=48, pipeline="tiled", tile_size=8, tile_block=8,
                          supersample=2)
    rendered = dataclasses.replace(cfg, supersample=1, width=128, height=96)

    def emax(c):
        return TileGrid.create(width=128, height=96, num_splats=n, tile_size=8,
                               max_instance_mult=c.max_instance_mult).emax

    with torch.no_grad():
        d = R.prepare_splats(scene, cam, rendered, sort=False)
        need = int(instance_demand(d["mean2d"], d["extent"],
                                   TileGrid.create(width=128, height=96, num_splats=n,
                                                   tile_size=8)))
        at_output = st.calibrate_config(scene, cam, dataclasses.replace(cfg, supersample=1))
        assert emax(at_output) < need  # sized at 64x48, it would drop instances
        cal = st.calibrate_config(scene, cam, cfg)
        assert emax(cal) >= need and cal.supersample == 2
        for c, dropped in ((cal, False), (at_output, True)):
            _, aux = composite_tiled(d, dataclasses.replace(
                rendered, max_instance_mult=c.max_instance_mult), return_aux=True)
            assert (int(aux["num_culled_instances"]) > 0) == dropped
        img = st.render(scene, cam, cal)
        assert img.shape == (48, 64, 4) and float(img[..., 3].max()) > 0.5
