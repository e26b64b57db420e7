"""PyTorch port vs. the JAX package: transforms, SH, projection and
prepare_splats(sort=False), on the CPU.

The same numpy arrays (made from a seed) go through both packages. Tolerance:
rtol 1e-5 / atol 1e-5 in float32 — both sides run the same arithmetic in the
same order, so only the two backends' elementwise rounding (exp, log, sqrt,
fused multiply-adds) differs.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from splatapult_tpu.core import project as jproject, sh as jsh, transforms as jT
from splatapult_tpu.io.synth import garden_cameras as jgarden_cameras
from splatapult_tpu.io.synth import make_garden_scene as jmake_garden_scene
from splatapult_tpu.render import RenderConfig as JRenderConfig
from splatapult_tpu.render import prepare_splats as jprepare_splats

from splatapult_tpu_torch import convert
from splatapult_tpu_torch.core import project as tproject, sh as tsh, transforms as tT
from splatapult_tpu_torch.io.synth import garden_cameras, make_garden_scene
from splatapult_tpu_torch.render import prepare_splats

# One thread for torch: the suite runs several worker processes per machine,
# and an oversubscribed intra-op thread pool slows every worker down.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(20261016)


def test_quat_rotmat_and_covariance_match(rng):
    q = rng.standard_normal((257, 4)).astype(np.float32)
    ls = rng.uniform(-4.0, 0.5, (257, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tT.quat_to_rotmat(_t(q)).numpy(), np.asarray(jT.quat_to_rotmat(jnp.asarray(q))), **TOL)
    np.testing.assert_allclose(
        tT.bake_covariance(_t(q), _t(ls)).numpy(),
        np.asarray(jT.bake_covariance(jnp.asarray(q), jnp.asarray(ls))), **TOL)
    v = rng.standard_normal((33, 3)).astype(np.float32)
    v[0] = 0.0  # the safe-normalize branch
    np.testing.assert_allclose(
        tT.normalize(_t(v)).numpy(), np.asarray(jT.normalize(jnp.asarray(v))), **TOL)


def test_camera_matrices_match():
    eye, target, up = [1.2, 1.1, 1.3], [0.3, 0.3, 0.3], [0.0, 1.0, 0.0]
    c2w = tT.look_at(eye, target, up)
    np.testing.assert_allclose(c2w, np.asarray(jT.look_at(eye, target, up)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tT.invert_rigid(_t(c2w)).numpy(), np.asarray(jT.invert_rigid(jnp.asarray(c2w))), **TOL)
    for far in (1000.0, 0.0):  # finite and infinite far plane
        np.testing.assert_array_equal(
            tT.perspective(np.pi / 4, 1.5, 0.1, far),
            np.asarray(jT.perspective(np.pi / 4, 1.5, 0.1, far)))
    np.testing.assert_array_equal(
        tT.projection_from_tan_angles(-0.9, 1.1, 0.8, -0.7, 0.1, 100.0),
        np.asarray(jT.projection_from_tan_angles(-0.9, 1.1, 0.8, -0.7, 0.1, 100.0)))


def test_srgb_to_linear_matches(rng):
    c = rng.uniform(-0.2, 1.3, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tT.srgb_to_linear(_t(c)).numpy(), np.asarray(jT.srgb_to_linear(jnp.asarray(c))), **TOL)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_basis_and_radiance_match(rng, degree):
    d = rng.standard_normal((128, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    sh = (rng.standard_normal((128, 3, 16)) * 0.3).astype(np.float32)
    np.testing.assert_allclose(
        tsh.sh_basis(_t(d), degree).numpy(), np.asarray(jsh.sh_basis(jnp.asarray(d), degree)), **TOL)
    np.testing.assert_allclose(
        tsh.eval_sh_radiance(_t(sh), _t(d), degree).numpy(),
        np.asarray(jsh.eval_sh_radiance(jnp.asarray(sh), jnp.asarray(d), degree)), **TOL)
    # stored-degree default: K coefficients -> their own degree
    k = jsh.NUM_COEFFS[degree]
    np.testing.assert_allclose(
        tsh.eval_sh_radiance(_t(sh[..., :k]), _t(d)).numpy(),
        np.asarray(jsh.eval_sh_radiance(jnp.asarray(sh[..., :k]), jnp.asarray(d))), **TOL)


def test_parity_constants_match():
    for name in ("COV2D_DILATION", "EXTENT_SIGMA", "PRESORT_CLIP", "GUARD_NDC_Z",
                 "GUARD_NDC_XY", "ALPHA_CUTOFF"):
        assert getattr(tproject, name) == getattr(jproject, name), name
    for name in ("SH_K0", "SH_K1", "SH_K2", "SH_K3", "SH_K4", "SH_K5", "SH_K6",
                 "SH_K7", "SH_K8", "SH_K9", "NUM_COEFFS"):
        assert getattr(tsh, name) == getattr(jsh, name), name


@pytest.fixture(scope="module")
def garden():
    """2k-splat garden + its 96x64 camera, the same arrays on both sides."""
    jscene = jmake_garden_scene(2000, seed=0)
    jcam = jgarden_cameras(1, width=96, height_px=64)
    tscene = convert.scene_from_numpy(jscene, device="cpu")
    tcam = convert.camera_from_numpy(
        np.asarray(jcam.cam_to_world), np.asarray(jcam.proj), device="cpu")
    return jscene, jcam, tscene, tcam


def test_synth_scene_and_camera_identical(garden):
    jscene, jcam, _, _ = garden
    own = make_garden_scene(2000, seed=0, device="cpu")
    for f in ("means", "sh", "opacities", "log_scales", "quats"):
        np.testing.assert_array_equal(getattr(own, f).numpy(), np.asarray(getattr(jscene, f)), f)
    cam = garden_cameras(1, width=96, height_px=64, device="cpu")
    np.testing.assert_allclose(cam.cam_to_world.numpy(), np.asarray(jcam.cam_to_world),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(cam.proj.numpy(), np.asarray(jcam.proj))
    ring = garden_cameras(3, width=96, height_px=64, device="cpu")
    jring = jgarden_cameras(3, width=96, height_px=64)
    assert ring.cam_to_world.shape == (3, 4, 4)
    np.testing.assert_allclose(ring.cam_to_world.numpy(), np.asarray(jring.cam_to_world),
                               rtol=1e-6, atol=1e-6)


def test_project_gaussians_matches(garden):
    jscene, jcam, tscene, tcam = garden
    jcov = jT.bake_covariance(jscene.quats, jscene.log_scales)
    jview = jT.invert_rigid(jcam.cam_to_world)
    want = jproject.project_gaussians(jscene.means, jcov, jview, jcam.proj, (96, 64))
    got = tproject.project_gaussians(
        tscene.means, tT.bake_covariance(tscene.quats, tscene.log_scales),
        tT.invert_rigid(tcam.cam_to_world), tcam.proj, (96, 64))
    mask = np.asarray(want.mask)
    np.testing.assert_array_equal(got.mask.numpy(), mask)
    assert 0 < mask.sum() < mask.size  # the view both keeps and culls splats
    for f in ("mean2d", "cov2d", "conic", "depth"):
        # culled splats may sit at the safe-divide guards; compare the kept
        np.testing.assert_allclose(
            getattr(got, f).numpy()[mask], np.asarray(getattr(want, f))[mask],
            rtol=1e-5, atol=1e-5, err_msg=f)
    for f in ("radius", "extent"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    np.testing.assert_allclose(
        tproject.view_dirs(tscene.means, tcam.eye).numpy(),
        np.asarray(jproject.view_dirs(jscene.means, jcam.eye)), **TOL)


@pytest.mark.parametrize("knobs", [
    {}, {"sh_degree": 0}, {"srgb_radiance_to_linear": True}, {"alpha_cutoff": 0.0},
], ids=["default", "nosh", "srgb", "no_cutoff"])
def test_prepare_splats_matches(garden, knobs):
    jscene, jcam, tscene, tcam = garden
    jcfg = JRenderConfig(width=96, height=64, pipeline="tiled", **knobs)
    want = jprepare_splats(jscene, jcam, jcfg, sort=False)
    got = prepare_splats(tscene, tcam, convert.config_from_jax(jcfg), sort=False)
    assert set(got) == set(want)
    mask = np.asarray(want["mask"])
    np.testing.assert_array_equal(got["mask"].numpy(), mask)
    for k in ("rgb", "alpha", "radius", "extent"):  # zeroed where masked
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    for k in ("mean2d", "conic", "depth"):
        np.testing.assert_allclose(got[k].numpy()[mask], np.asarray(want[k])[mask],
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    # the extents-zero pattern (culled, or opacity below the cutoff) is equal
    np.testing.assert_array_equal(got["extent"].numpy() == 0.0, np.asarray(want["extent"]) == 0.0)
    assert (got["rgb"].numpy()[~mask] == 0.0).all()


def test_prepare_masks_nan_colour(garden):
    _, _, tscene, tcam = garden
    import dataclasses

    means = tscene.means.clone()
    means[5] = float("nan")
    scene = dataclasses.replace(tscene, means=means)
    from splatapult_tpu_torch.render import RenderConfig

    d = prepare_splats(scene, tcam, RenderConfig(width=96, height=64), sort=False)
    assert not bool(d["mask"][5])
    assert torch.isfinite(d["rgb"]).all() and float(d["alpha"][5]) == 0.0
    assert (d["extent"][5] == 0).all()
