"""PyTorch port vs. the JAX package: the training slice as a whole (gradients
of an L2 image loss through the tiled render, and fit_scene), on the CPU.

The JAX side differentiates through its Pallas kernels in interpret mode; the
port runs the plain versions of its CUDA kernels under torch autograd. Both
get the same scene, camera and target arrays, made from numpy seeds.

Tolerances. Gradients: each field within 2e-4 of that field's largest
gradient magnitude (observed: below 3e-5) — the composite backward differs in
rounding and summation order (see test_torch_composite_bwd.py), prepare agrees
to ~1e-6 relative. Finite differences (alpha_cutoff = 0, so the render is
smooth): 8 % of the larger of the two values, float32 central differences, as
tests/test_grads.py. fit_scene: losses within rtol 1e-4 of the JAX losses step
for step over 5 steps — Adam divides by the root of the squared gradient, so
a coordinate whose gradient is rounding noise moves differently in the two
packages, which the loss barely sees; positions and colours, whose gradients
are well above the noise, agree to 1e-5 after the 5 steps.
"""

import dataclasses
import json

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
from splatapult_tpu.render import render as jrender
from splatapult_tpu.train import fit_scene as jfit_scene

import splatapult_tpu_torch as st
from splatapult_tpu_torch import cli, convert, train
from splatapult_tpu_torch.io.gaussians import load_gaussian_ply, save_gaussian_ply
from splatapult_tpu_torch.io.synth import make_garden_scene
from splatapult_tpu_torch.utils.image import save_png

# One thread for torch: the suite runs several worker processes per machine,
# and an oversubscribed intra-op thread pool slows every worker down.
torch.set_num_threads(1)

FIELDS = ("means", "sh", "opacities", "log_scales", "quats")
GRAD_REL_TOL = 2e-4


def _random_64():
    """The 64-splat tiled case of tests/test_grads.py."""
    rng = np.random.default_rng(21)
    n = 64
    quats = rng.standard_normal((n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    scene = JGaussianScene(
        means=jnp.asarray(rng.uniform(-0.8, 0.8, (n, 3)), jnp.float32),
        sh=jnp.asarray(rng.standard_normal((n, 3, 1)) * 0.5, jnp.float32),
        opacities=jnp.asarray(rng.uniform(-1, 2.5, (n,)), jnp.float32),
        log_scales=jnp.asarray(rng.uniform(-3.5, -1.5, (n, 3)), jnp.float32),
        quats=jnp.asarray(quats),
    )
    cam = JCamera.from_fov(
        jT.look_at(eye=[1.2, 1.1, 1.3], target=[0.3, 0.3, 0.3], up=[0, 1, 0]),
        fovy=np.pi / 4, width=64, height=64)
    cfg = JRenderConfig(width=64, height=64, pipeline="tiled", tile_size=16,
                        tile_block=8, max_instance_mult=20)
    return scene, cam, cfg


def _garden_2k():
    return (jmake_garden_scene(2000, seed=0), jgarden_cameras(1, width=96, height_px=64),
            JRenderConfig(width=96, height=64, pipeline="tiled", tile_size=16,
                          tile_block=8, max_instance_mult=4.0))


def _port_side(jscene, jcam, jcfg):
    return (convert.scene_from_numpy(jscene, device="cpu"),
            convert.camera_from_numpy(np.asarray(jcam.cam_to_world), np.asarray(jcam.proj),
                                      device="cpu"),
            convert.config_from_jax(jcfg))


def _port_grads(scene, cam, cfg, target):
    """Gradients of the L2 loss for the five fields and cam_to_world."""
    for name in FIELDS:
        getattr(scene, name).requires_grad_(True)
    cam.cam_to_world.requires_grad_(True)
    loss = train.l2_image_loss(st.render(scene, cam, cfg), torch.from_numpy(target))
    loss.backward()
    grads = {name: getattr(scene, name).grad.numpy() for name in FIELDS}
    grads["cam_to_world"] = cam.cam_to_world.grad.numpy()
    return float(loss.detach()), grads


@pytest.fixture(scope="module")
def grad_cases():
    """Both packages' gradients on both cases, computed once."""
    out = {}
    for name, (jscene, jcam, jcfg) in (("random64", _random_64()), ("garden2k", _garden_2k())):
        target = np.random.default_rng(7).uniform(
            size=(jcfg.height, jcfg.width, 4)).astype(np.float32)
        jtarget = jnp.asarray(target)

        def loss(s, c2w):
            img = jrender(s, JCamera(cam_to_world=c2w, proj=jcam.proj), jcfg)
            return jnp.mean((img - jtarget) ** 2)

        jloss, (gs, gc) = jax.value_and_grad(loss, argnums=(0, 1))(jscene, jcam.cam_to_world)
        want = {f: np.asarray(getattr(gs, f)) for f in FIELDS}
        want["cam_to_world"] = np.asarray(gc)
        got_loss, got = _port_grads(*_port_side(jscene, jcam, jcfg), target)
        out[name] = {"want": want, "got": got, "loss": (got_loss, float(jloss))}
    return out


@pytest.mark.parametrize("field", FIELDS + ("cam_to_world",))
@pytest.mark.parametrize("case", ["random64", "garden2k"])
def test_render_grads_match_jax(grad_cases, case, field):
    got, want = grad_cases[case]["got"][field], grad_cases[case]["want"][field]
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = np.abs(want).max()
    assert scale > 0.0
    assert np.abs(got - want).max() <= GRAD_REL_TOL * scale, np.abs(got - want).max() / scale
    got_loss, want_loss = grad_cases[case]["loss"]
    assert abs(got_loss - want_loss) <= 1e-6 * want_loss


def test_masked_splats_get_zero_finite_grads(grad_cases):
    """Culled splats (alpha forced to 0, log clamped at 1e-37) and splats with
    no tile instance: every gradient exactly zero, none NaN."""
    got = grad_cases["garden2k"]["got"]
    dead = np.abs(got["opacities"]) == 0
    assert 100 < dead.sum() < 1900
    for f in FIELDS:
        g = got[f].reshape(len(dead), -1)
        assert np.isfinite(g).all() and (g[dead] == 0).all(), f


def test_culled_splats_that_overflow_keep_gradients_finite():
    """A splat on the camera plane (tz = 0) overflows the projected covariance
    to inf. It is culled and its upstream gradient is exactly 0, but 0 * inf
    would be NaN: the port projects culled splats from a stand-in position.
    (The JAX package returns NaN gradients for such splats.)"""
    jscene, jcam, jcfg = _random_64()
    scene, cam, cfg = _port_side(jscene, jcam, jcfg)
    eye = cam.eye.clone()
    right = cam.cam_to_world[:3, 0]
    with torch.no_grad():
        scene.means[0] = eye  # at the eye
        scene.means[1] = eye + 0.3 * right  # on the camera plane, off axis
        scene.means[2] = eye + 0.3 * right - 1e-6 * cam.cam_to_world[:3, 2]
    target = np.zeros((64, 64, 4), np.float32)
    _, grads = _port_grads(scene, cam, cfg, target)
    for f in FIELDS:
        g = grads[f].reshape(64, -1)
        assert np.isfinite(g).all(), f
        assert (g[:3] == 0).all() and np.abs(g[3:]).max() > 0, f
    assert np.isfinite(grads["cam_to_world"]).all()


@pytest.mark.parametrize("field", FIELDS)
def test_render_grads_match_finite_differences(field):
    jscene, jcam, jcfg = _random_64()
    scene, cam, cfg = _port_side(jscene, jcam, jcfg)
    cfg = dataclasses.replace(cfg, alpha_cutoff=0.0)
    target = np.random.default_rng(7).uniform(size=(64, 64, 4)).astype(np.float32)
    _, grads = _port_grads(scene, cam, cfg, target)
    g = grads[field]
    arr = getattr(scene, field).detach().numpy().astype(np.float64)

    def loss_at(flat):
        s = dataclasses.replace(
            scene, **{field: torch.from_numpy(flat.reshape(arr.shape).astype(np.float32))})
        with torch.no_grad():
            return float(train.l2_image_loss(st.render(s, cam, cfg), torch.from_numpy(target)))

    flat = np.abs(g).ravel()
    rng = np.random.default_rng(3)
    top = list(np.argsort(-flat)[:4])
    for idx in top + list(rng.integers(0, flat.size, 2)):
        if flat[idx] == 0.0 and idx not in top:
            continue
        eps = 3e-3 * max(1.0, abs(arr.ravel()[idx]))
        up, dn = arr.copy().ravel(), arr.copy().ravel()
        up[idx] += eps
        dn[idx] -= eps
        fd = (loss_at(up) - loss_at(dn)) / (2 * eps)
        got = g.ravel()[idx]
        scale = max(abs(fd), abs(got), 1e-4)
        assert abs(fd - got) / scale < 0.08, f"{field}[{idx}]: fd={fd:.6g} analytic={got:.6g}"


def test_forward_only_render_cannot_be_differentiated():
    scene, cam, cfg = _port_side(*_random_64())
    scene.means.requires_grad_(True)
    img = st.render(scene, cam, dataclasses.replace(cfg, forward_only=True))
    with pytest.raises(ValueError, match="forward_only=True"):
        img.sum().backward()
    img = st.render(scene, cam, dataclasses.replace(cfg, grad_sort_dtype="bfloat16"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        img.sum().backward()


def _fit_case():
    """Debug scene, two 32 x 32 views, targets rendered by the JAX package from
    the true scene; the start is a perturbed copy."""
    true = jmake_debug_scene()
    jcfg = JRenderConfig(width=32, height=32, pipeline="tiled", tile_size=16, tile_block=8,
                         max_instance_mult=20)
    cams = [JCamera.from_fov(
        jT.look_at(eye=[np.cos(a) * 1.8, 1.0, np.sin(a) * 1.8], target=[0.3, 0.3, 0.3],
                   up=[0, 1, 0]), fovy=np.pi / 4, width=32, height=32)
        for a in np.linspace(0.3, 1.5, 2)]
    jcams = JCamera(cam_to_world=jnp.stack([c.cam_to_world for c in cams]),
                    proj=jnp.stack([c.proj for c in cams]))
    targets = jnp.stack([jrender(true, JCamera(cam_to_world=m, proj=p), jcfg)
                         for m, p in zip(jcams.cam_to_world, jcams.proj)])
    rng = np.random.default_rng(0)
    start = JGaussianScene(
        means=true.means + jnp.asarray(rng.normal(0, 0.03, (16, 3)), jnp.float32),
        sh=true.sh + jnp.asarray(rng.normal(0, 0.2, (16, 3, 16)), jnp.float32),
        opacities=true.opacities, log_scales=true.log_scales, quats=true.quats)
    return start, jcams, targets, jcfg


@pytest.fixture(scope="module")
def fit_runs():
    start, jcams, targets, jcfg = _fit_case()
    jfitted, jlosses = jfit_scene(start, jcams, targets, jcfg, steps=5, learning_rate=2e-2)
    scene, cams, cfg = _port_side(start, jcams, jcfg)
    before = convert.scene_to_numpy(scene)
    fitted, losses = train.fit_scene(scene, cams, np.asarray(targets), cfg, steps=5,
                                     learning_rate=2e-2)
    seen = []
    fitted_cb, losses_cb = train.fit_scene(
        scene, cams, np.asarray(targets), cfg, steps=5, learning_rate=2e-2,
        callback=lambda step, s, loss: seen.append((step, loss, s.means.grad is not None)))
    return {"jax": (jfitted, jlosses), "port": (fitted, losses), "port_cb": (fitted_cb, losses_cb),
            "seen": seen, "before": before, "start": scene}


def test_fit_scene_losses_match_jax_step_for_step(fit_runs):
    jfitted, jlosses = fit_runs["jax"]
    fitted, losses = fit_runs["port"]
    assert len(losses) == 5 and all(isinstance(x, float) for x in losses)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    after = convert.scene_to_numpy(fitted)
    for f in ("means", "sh"):
        np.testing.assert_allclose(after[f], np.asarray(getattr(jfitted, f)), rtol=0, atol=1e-5)
    assert not fitted.means.requires_grad


def test_fit_scene_loss_falls_and_input_is_untouched(fit_runs):
    fitted, losses = fit_runs["port"]
    assert np.isfinite(losses).all() and losses[-1] < 0.5 * losses[0]
    now = convert.scene_to_numpy(fit_runs["start"])
    for f in FIELDS:
        np.testing.assert_array_equal(now[f], fit_runs["before"][f])
        assert getattr(fit_runs["start"], f).grad is None
    assert np.abs(convert.scene_to_numpy(fitted)["sh"] - now["sh"]).max() > 1e-3


def test_fit_scene_callback_loop_matches_chunked_loop(fit_runs):
    fitted, losses = fit_runs["port"]
    fitted_cb, losses_cb = fit_runs["port_cb"]
    np.testing.assert_allclose(losses_cb, losses, rtol=1e-6)
    a, b = convert.scene_to_numpy(fitted), convert.scene_to_numpy(fitted_cb)
    for f in FIELDS:
        np.testing.assert_allclose(a[f], b[f], rtol=1e-4, atol=1e-6)
    assert [s for s, _, _ in fit_runs["seen"]] == [0, 1, 2, 3, 4]
    assert [loss for _, loss, _ in fit_runs["seen"]] == losses_cb
    assert all(has_grad for _, _, has_grad in fit_runs["seen"])


def test_fit_scene_chunks_and_options(monkeypatch):
    """More steps than one chunk; a custom optimizer factory; the deferred
    multi-device options raise."""
    start, jcams, targets, jcfg = _fit_case()
    scene, cams, cfg = _port_side(start, jcams, jcfg)
    monkeypatch.setattr(train, "_FIT_CHUNK", 2)
    _, losses = train.fit_scene(scene, cams, np.asarray(targets), cfg, steps=5,
                                learning_rate=2e-2)
    monkeypatch.undo()
    _, whole = train.fit_scene(scene, cams, np.asarray(targets), cfg, steps=5,
                               learning_rate=2e-2)
    assert losses == whole and len(losses) == 5
    _, sgd = train.fit_scene(
        scene, cams, np.asarray(targets), cfg, steps=3,
        optimizer=lambda p: torch.optim.SGD([p.sh, p.means], lr=1.0))
    assert sgd[0] == whole[0] and sgd[-1] < sgd[0]
    # one view given unbatched
    one = st.Camera(cam_to_world=cams.cam_to_world[0], proj=cams.proj[0])
    _, single = train.fit_scene(scene, one, np.asarray(targets)[:1], cfg, steps=1)
    assert np.isfinite(single).all()
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        train.fit_scene(scene, cams, np.asarray(targets), cfg, steps=1, mesh=object())
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        train.fit_scene(scene, cams, np.asarray(targets), cfg, steps=1, param_shard=True)


def test_default_optimizer_groups():
    scene = make_garden_scene(10, seed=0, device="cpu")
    opt = train.default_optimizer(scene, 1e-2)
    lrs = {id(g["params"][0]): g["lr"] for g in opt.param_groups}
    want = {"means": 1e-3, "sh": 1e-2, "opacities": 1e-2, "log_scales": 5e-3, "quats": 1e-3}
    for name, lr in want.items():
        assert lrs[id(getattr(scene, name))] == pytest.approx(lr)
    assert all(g["betas"] == (0.9, 0.999) and g["eps"] == 1e-8 for g in opt.param_groups)


def test_cli_fit_on_cpu(tmp_path, capsys):
    true = make_garden_scene(400, seed=3, device="cpu")
    rig = cli._orbit_rig(true, 2, 48, 32, fovy=np.deg2rad(45.0), device="cpu")
    cfg = st.RenderConfig(width=48, height=32, pipeline="tiled", tile_size=16)
    for i in range(2):
        view = st.Camera(cam_to_world=rig.cam_to_world[i], proj=rig.proj[i])
        save_png(str(tmp_path / f"t{i}.png"), st.render(true, view, cfg).numpy())
    start = dataclasses.replace(true, sh=true.sh * 0.5)
    ply, out = str(tmp_path / "start.ply"), str(tmp_path / "fitted.ply")
    save_gaussian_ply(ply, start)
    capsys.readouterr()
    cli.main(["fit", ply, "--targets", str(tmp_path / "t*.png"), "-o", out, "--steps", "4",
              "--lr", "0.02", "--tile-size", "16", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["steps"] == 4 and line["views"] == 2 and line["splats"] == 400
    assert line["output"] == out and line["densify_events"] == []
    assert np.isfinite([line["loss_first"], line["loss_last"]]).all()
    assert line["loss_last"] < line["loss_first"]
    fitted = load_gaussian_ply(out, device="cpu")
    assert fitted.num_gaussians == 400 and not torch.equal(fitted.sh, start.sh)
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        cli.main(["fit", ply, "--targets", str(tmp_path / "t*.png"), "--adaptive",
                  "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli.main(["fit", ply, "--targets", str(tmp_path / "none*.png"), "--device", "cpu"])
