"""PyTorch port vs. the JAX package: the host-side modules (cameras.json and
<ply>_vr.json configs, the camera overlay, point clouds, prune, the transforms
the exporters use, checkpoints, the float64 oracle, render statistics, the
native PLY codec) and the CLI's path / points / export / info / save-pose /
render --stereo / render --camera-index --show-cameras / render
--supersample / fit with cameras.json, on the CPU at 32x32.

Every file these tests read is written by them into a temporary directory.
The host modules are numpy copies: equal to the JAX package's bit for bit
where they compute the same arithmetic (configs, overlay, points, the
oracle). The torch transforms: 1e-6 (float32 elementwise rounding); through
eigh, the scales 1e-5 (two solvers) and the rebuilt covariance 1e-5, as
tests/test_transforms.py. Adam resumed
from a checkpoint: bit for bit.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import jax
import pytest
import torch

from splatapult_tpu.core import transforms as jT
from splatapult_tpu.diagnostics import render_stats as jrender_stats
from splatapult_tpu.io import checkpoint as jckpt
from splatapult_tpu.io import configs as jconfigs
from splatapult_tpu.io import points as jpoints
from splatapult_tpu.io.gaussians import GaussianScene as JGaussianScene
from splatapult_tpu.io.gaussians import make_debug_scene as jmake_debug_scene
from splatapult_tpu.io.gaussians import prune_splats as jprune_splats
from splatapult_tpu.reference.raster import reference_render as jreference_render
from splatapult_tpu.render import Camera as JCamera
from splatapult_tpu.render import RenderConfig as JRenderConfig
from splatapult_tpu.utils import overlay as joverlay

import splatapult_tpu_torch as st
from splatapult_tpu_torch import cli, convert, diagnostics, train
from splatapult_tpu_torch.core import transforms as tT
from splatapult_tpu_torch.io import checkpoint, configs, native, points
from splatapult_tpu_torch.io.gaussians import load_gaussian_ply, prune_splats, save_gaussian_ply
from splatapult_tpu_torch.io.ply import read_ply
from splatapult_tpu_torch.io.synth import make_garden_scene
from splatapult_tpu_torch.reference.raster import reference_render
from splatapult_tpu_torch.utils import overlay
from splatapult_tpu_torch.utils.image import load_png

# One thread for torch: the suite runs several worker processes per machine,
# and an oversubscribed intra-op thread pool slows every worker down.
torch.set_num_threads(1)

FIELDS = ("means", "sh", "opacities", "log_scales", "quats")


def _write_cameras_json(path, n=4, size=(64, 48)):
    """n orbit cameras around the garden's centre, in the INRIA trainer's
    cameras.json form (rotation columns = camera x, y, z in world; y down, z
    forward)."""
    cams = []
    for i, a in enumerate(np.linspace(0, 2 * np.pi, n, endpoint=False)):
        eye = np.asarray([np.cos(a) * 4.2, 1.6, np.sin(a) * 4.2])
        fwd = np.asarray([0.0, 0.8, 0.0]) - eye
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        cams.append({"id": i, "img_name": f"{i:05d}", "width": size[0], "height": size[1],
                     "position": eye.tolist(), "rotation": np.stack([right, -up, fwd], 1).tolist(),
                     "fx": 60.0 + i, "fy": 61.0})
    with open(path, "w") as f:
        json.dump(cams, f)


@pytest.fixture()
def scene_dir(tmp_path):
    """<tmp>/scene/point_cloud/g.ply (1000-splat garden) with cameras.json
    one level up."""
    d = tmp_path / "scene" / "point_cloud"
    os.makedirs(d)
    save_gaussian_ply(str(d / "g.ply"), make_garden_scene(1000, seed=0, device="cpu"))
    _write_cameras_json(str(tmp_path / "scene" / "cameras.json"))
    return d


def test_configs_match_jax(scene_dir, tmp_path):
    ply = str(scene_dir / "g.ply")
    found, jfound = configs.discover_scene(ply), jconfigs.discover_scene(ply)
    assert found == jfound and found["cameras_json"].endswith(os.path.join("scene",
                                                                           "cameras.json"))
    cams, jcams = (mod.load_cameras_json(found["cameras_json"]) for mod in (configs, jconfigs))
    assert len(cams) == len(jcams) == 4
    for c, j in zip(cams, jcams):
        assert (c.id, c.width, c.height, c.fx, c.fy) == (j.id, j.width, j.height, j.fx, j.fy)
        np.testing.assert_array_equal(c.cam_to_world, j.cam_to_world)
        np.testing.assert_array_equal(c.fov, j.fov)
    for a, b in zip(configs.estimate_floor_plane(cams), jconfigs.estimate_floor_plane(jcams)):
        np.testing.assert_array_equal(a, b)
    m = np.arange(16, dtype=np.float32).reshape(4, 4) / 7.0
    m[3] = [0, 0, 0, 1]
    configs.save_vr_config(str(scene_dir / "g_vr.json"), m)
    np.testing.assert_array_equal(jconfigs.load_vr_config(str(scene_dir / "g_vr.json")),
                                  configs.load_vr_config(str(scene_dir / "g_vr.json")))
    assert configs.discover_scene(ply) == jconfigs.discover_scene(ply)
    assert configs.find_config_file("nope.json", str(scene_dir)) is None


def test_overlay_matches_jax(tmp_path):
    _write_cameras_json(str(tmp_path / "cameras.json"))
    cams = configs.load_cameras_json(str(tmp_path / "cameras.json"))
    jcams = jconfigs.load_cameras_json(str(tmp_path / "cameras.json"))
    segs, jsegs = overlay.camera_overlay_lines(cams), joverlay.camera_overlay_lines(jcams)
    assert len(segs) == len(jsegs) == 4 * 8 + 3
    for (a0, a1, ac), (b0, b1, bc) in zip(segs, jsegs):
        np.testing.assert_array_equal(a0, b0)
        np.testing.assert_array_equal(a1, b1)
        assert ac == bc
    view = tT.look_at(eye=[6.0, 5.0, 6.0], target=[0.0, 1.0, 0.0], up=[0, 1, 0])
    proj = tT.perspective(np.pi / 3, 1.0, 0.1, 100.0)
    img = np.random.default_rng(2).uniform(size=(32, 32, 4)).astype(np.float32)
    got = overlay.draw_lines(img, segs, view, proj, 32, 32)
    np.testing.assert_array_equal(got, joverlay.draw_lines(img, jsegs, view, proj, 32, 32))
    assert (got != img).any()


def test_points_prune_and_transforms_match_jax(tmp_path):
    pts, jpts = points.make_debug_points(), jpoints.make_debug_points()
    np.testing.assert_array_equal(pts.positions, jpts.positions)
    points.save_point_ply(str(tmp_path / "p.ply"), pts)
    back = points.load_point_ply(str(tmp_path / "p.ply"), use_linear_colors=True)
    jback = jpoints.load_point_ply(str(tmp_path / "p.ply"), use_linear_colors=True)
    np.testing.assert_array_equal(back.colors, np.asarray(jback.colors))
    splats = points.points_as_gaussians(back, world_radius=0.02, device="cpu")
    jsplats = jpoints.points_as_gaussians(jback, world_radius=0.02)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(splats, f).numpy(), np.asarray(getattr(jsplats, f)))

    scene = make_garden_scene(500, seed=3, device="cpu")
    jscene = jprune_splats(JGaussianScene(**convert.scene_to_numpy(scene)),
                           origin=[0.5, 1.0, -0.5], num_splats=120)
    pruned = prune_splats(scene, origin=[0.5, 1.0, -0.5], num_splats=120)
    assert pruned.num_gaussians == 120 and prune_splats(scene, [0, 0, 0], 900) is scene
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(pruned, f).numpy(), np.asarray(getattr(jscene, f)))

    rng = np.random.default_rng(9)
    q = rng.standard_normal((64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[:, 0] = np.abs(q[:, 0])
    R = tT.quat_to_rotmat(torch.from_numpy(q))
    log_s = torch.from_numpy(rng.uniform(-3.0, 0.5, (64, 3)).astype(np.float32))
    cov = tT.bake_covariance(torch.from_numpy(q), log_s)
    c = torch.from_numpy(rng.uniform(0, 1, (200,)).astype(np.float32))
    jq, (_, js2), jsrgb = jax.jit(lambda R, cov, c: (
        jT.rotmat_to_quat(R), jT.covariance_to_quat_scale(cov), jT.linear_to_srgb(c)))(
        R.numpy(), cov.numpy(), c.numpy())
    np.testing.assert_allclose(tT.rotmat_to_quat(R).numpy(), np.asarray(jq), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tT.rotmat_to_quat(R).numpy(), q, rtol=0, atol=1e-5)
    q2, s2 = tT.covariance_to_quat_scale(cov)
    np.testing.assert_allclose(s2.numpy(), np.asarray(js2), rtol=1e-5, atol=1e-5)
    # the eigenvectors' signs are each solver's choice: compare covariances
    np.testing.assert_allclose(tT.bake_covariance(q2, torch.log(s2)).numpy(), cov.numpy(),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tT.linear_to_srgb(c).numpy(), np.asarray(jsrgb), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tT.srgb_to_linear(tT.linear_to_srgb(c)).numpy(), c.numpy(),
                               rtol=0, atol=1e-6)


def test_scene_npz_loads_across_packages(tmp_path):
    scene = make_garden_scene(300, seed=1, device="cpu")
    checkpoint.save_scene_npz(str(tmp_path / "t.npz"), scene, step=42)
    jscene, jstep = jckpt.load_scene_npz(str(tmp_path / "t.npz"))
    assert jstep == 42
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jscene, f)), getattr(scene, f).numpy())
    jckpt.save_scene_npz(str(tmp_path / "j.npz"), jscene, step=7)
    back, step = checkpoint.load_scene_npz(str(tmp_path / "j.npz"), device="cpu")
    assert step == 7
    for f in FIELDS:
        assert torch.equal(getattr(back, f), getattr(scene, f)), f


def test_train_state_resumes_adam_bit_for_bit(tmp_path):
    """Three Adam steps, a checkpoint, two more from the loaded state, equal
    to five steps without the checkpoint."""
    gen = torch.Generator().manual_seed(0)
    start = make_garden_scene(200, seed=2, device="cpu")
    grads = [{f: torch.randn(getattr(start, f).shape, generator=gen) for f in FIELDS}
             for _ in range(5)]

    def params_of(scene):
        return dataclasses.replace(scene, **{
            f: getattr(scene, f).detach().clone().requires_grad_(True) for f in FIELDS})

    def steps(params, opt, gs):
        for g in gs:
            for f in FIELDS:
                getattr(params, f).grad = g[f].clone()
            opt.step()

    straight = params_of(start)
    steps(straight, train.default_optimizer(straight, 1e-2), grads)

    first = params_of(start)
    opt = train.default_optimizer(first, 1e-2)
    steps(first, opt, grads[:3])
    checkpoint.save_train_state(str(tmp_path), first, opt, step=3)
    with np.load(str(tmp_path / "step_00000003.npz"), allow_pickle=False) as z:
        assert "optim/state/0/exp_avg" in z.files  # arrays only, no pickled objects
    scene, state, step = checkpoint.load_train_state(str(tmp_path), 3, device="cpu")
    assert step == 3
    resumed = params_of(scene)
    opt2 = train.default_optimizer(resumed, 1e-2)
    opt2.load_state_dict(state)
    steps(resumed, opt2, grads[3:])
    for f in FIELDS:
        assert torch.equal(getattr(resumed, f), getattr(straight, f)), f


def test_reference_render_is_the_jax_oracle():
    scene = make_garden_scene(40, seed=8, device="cpu")
    cam = tT.look_at(eye=[4.2, 1.6, 0.0], target=[0.0, 0.8, 0.0], up=[0, 1, 0])
    args = [getattr(scene, f).numpy() for f in FIELDS] + [
        cam, tT.perspective(np.pi / 3, 24 / 20, 0.1, 100.0), 24, 20]
    got = reference_render(*args)
    assert got.dtype == np.float64 and got[..., 3].max() > 0.05
    np.testing.assert_array_equal(got, jreference_render(*args))
    np.testing.assert_array_equal(reference_render(*args, alpha_cutoff=0.0),
                                  jreference_render(*args, alpha_cutoff=0.0))


def test_render_stats_match_jax(monkeypatch):
    # the JAX function as it is, with the two stages it calls compiled as two
    # programs (XLA's backend optimisations off) instead of dispatched one
    # operation at a time: the same values, a fifth of the time
    import importlib

    jbinning = importlib.import_module("splatapult_tpu.ops.binning")
    jrender_module = importlib.import_module("splatapult_tpu.render")
    fast = {"xla_backend_optimization_level": 0}
    monkeypatch.setattr(jrender_module, "prepare_splats", jax.jit(
        jrender_module.prepare_splats, static_argnames=("config", "sort"),
        compiler_options=fast))
    monkeypatch.setattr(jbinning, "bin_splats", jax.jit(
        jbinning.bin_splats, static_argnames="grid", compiler_options=fast))
    jscene = jmake_debug_scene()
    # one camera for both, made by the port (numpy in, so JAX dispatches
    # nothing outside the two programs)
    cam = st.Camera.from_fov(tT.look_at(eye=[1.2, 1.1, 1.3], target=[0.3, 0.3, 0.3],
                                        up=[0, 1, 0]),
                             fovy=np.pi / 4, width=64, height=64, device="cpu")
    jcam = JCamera(cam_to_world=cam.cam_to_world.numpy(), proj=cam.proj.numpy())
    jcfg = JRenderConfig(width=64, height=64, pipeline="tiled", tile_size=16, tile_block=8,
                         max_instance_mult=20)
    want = jrender_stats(jscene, jcam, jcfg)
    got = diagnostics.render_stats(convert.scene_from_numpy(jscene, device="cpu"), cam,
                                   convert.config_from_jax(jcfg))
    assert got == want and got["num_instances"] > 0
    sink = {}
    with diagnostics.phase_timer(sink, "a"):
        pass
    with diagnostics.phase_timer(sink, "a"):
        pass
    assert sink["a"] >= 0.0


def test_native_codec_matches_numpy_path(tmp_path):
    """Wherever a C++ compiler is on PATH the library builds from the repo's
    native/splatply.cpp and decodes; its columns equal the numpy path's. Only
    a box with no compiler takes the numpy path alone."""
    compiler = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    assert native.available() == bool(compiler)
    rng = np.random.default_rng(6)
    n = 70_000  # > 1 << 16 records: the threaded path
    dt = np.dtype([("a", "<f4"), ("b", "<f8"), ("c", "u1"), ("d", "<i4")])
    v = np.zeros(n, dt)
    v["a"], v["b"] = rng.standard_normal(n), rng.standard_normal(n)
    v["c"], v["d"] = rng.integers(0, 255, n), rng.integers(-1000, 1000, n)
    got = native.decode_columns(v, ["a", "b", "c", "d"])
    assert native.path_used == ("native" if compiler else "numpy")
    want = np.stack([v[nm].astype(np.float32) for nm in "abcd"], axis=-1)
    np.testing.assert_array_equal(got, want)
    # scenes load through it
    scene = make_garden_scene(100, seed=4, device="cpu")
    save_gaussian_ply(str(tmp_path / "s.ply"), scene)
    ply = read_ply(str(tmp_path / "s.ply"))
    np.testing.assert_array_equal(ply.columns(["x", "y", "z"]), scene.means.numpy())
    assert native.available() == (native.path_used == "native")


@pytest.mark.parametrize("n", [500, 70_000])  # 70,000 > 1 << 16 records: the threaded path
def test_encode_columns_matches_jax(n):
    """io/native.encode_columns writes the same bytes as the JAX package's
    (tests/test_native.py's records: a padded dtype whose untouched bytes
    stay zero, float64 and int32 fields beside float32 ones) and decodes
    back to its input."""
    from splatapult_tpu.io import native as jnative

    rng = np.random.default_rng(7)
    dt = np.dtype([("x", "<f4"), ("pad", "u1"), ("y", "<f4"), ("z", "<f8"), ("i", "<i4")])
    vals = rng.standard_normal((n, 4)).astype(np.float32)
    vals[:, 3] = np.round(vals[:, 3] * 1000.0)
    names = ["x", "y", "z", "i"]
    got, want = np.zeros(n, dt), np.zeros(n, dt)
    native.encode_columns(vals, got, names)
    jnative.encode_columns(vals, want, names)
    assert got.tobytes() == want.tobytes()
    assert (got["pad"] == 0).all()
    np.testing.assert_array_equal(native.decode_columns(got, names), vals)


def test_cli_host_commands_and_cameras_json_on_cpu(scene_dir, tmp_path, capsys, caplog):
    """path (--every, --batch), points, export --prune, info, save-pose (and
    the next render picks up the floor), render --camera-index
    --show-cameras, render --stereo --eye-tan-angles, render --stereo
    --shared-bins (and its per-eye fallback), render --supersample,
    and fit against cameras.json with a <ply>_vr.json present: in-process,
    --device cpu, 32x32 (1000 splats: auto picks the global pipeline)."""
    ply = str(scene_dir / "g.ply")
    out = str(tmp_path / "o")
    view = ["--width", "32", "--height", "32", "--device", "cpu"]

    cli.main(["path", ply, "-o", out + "p.png", "--every", "2", *view])
    cli.main(["path", ply, "-o", out + "b.png", "--every", "2", "--batch", *view])
    for i in range(2):
        frame = load_png(f"{out}p_{i:04d}.png")
        assert frame.shape == (32, 32, 3) and frame.max() > 0.1
        np.testing.assert_array_equal(frame, load_png(f"{out}b_{i:04d}.png"))
    assert not os.path.exists(f"{out}p_0002.png")

    points.save_point_ply(str(tmp_path / "pts.ply"), points.make_debug_points())
    cli.main(["points", str(tmp_path / "pts.ply"), "-o", out + "pts.png",
              "--eye", "1.2", "1.1", "1.3", "--target", "0.3", "0.3", "0.3", *view])
    assert load_png(out + "pts.png").max() > 0.1

    cli.main(["export", ply, "-o", out + "e.ply", "--prune", "400",
              "--prune-origin", "0", "1", "0"])
    assert load_gaussian_ply(out + "e.ply", device="cpu").num_gaussians == 400

    capsys.readouterr()
    cli.main(["info", ply])
    info = capsys.readouterr().out
    assert "splats:      1000" in info and "cameras:     4" in info

    cli.main(["render", ply, "-o", out + "ci.png", "--camera-index", "1", *view])
    cli.main(["render", ply, "-o", out + "cis.png", "--camera-index", "1", "--show-cameras",
              *view])
    lines = np.abs(load_png(out + "cis.png") - load_png(out + "ci.png")).max(axis=-1) > 0
    assert lines.any()
    cli.main(["render", ply, "-o", out + "st.png", "--stereo", "--eye-tan-angles",
              "-0.5", "0.3", "0.4", "-0.4", "-0.3", "0.5", "0.4", "-0.4", *view])
    assert load_png(out + "st.png").shape == (32, 64, 3)
    cli.main(["render", ply, "-o", out + "ss.png", "--supersample", "2", *view])
    assert load_png(out + "ss.png").shape == (32, 32, 3)
    # --shared-bins on the tiled pipeline bins once for both eyes: each eye
    # within one 8-bit step of the per-eye PNG of the same view
    tiled = [*view, "--pipeline", "tiled"]
    cli.main(["render", ply, "-o", out + "pe.png", "--stereo", *tiled])
    caplog.clear()
    cli.main(["render", ply, "-o", out + "sb.png", "--stereo", "--shared-bins", *tiled])
    assert "per-eye render path" not in caplog.text
    shared, per_eye = load_png(out + "sb.png"), load_png(out + "pe.png")
    assert shared.shape == (32, 64, 3) and shared.max() > 0.1
    assert np.abs(shared - per_eye).max() <= 1.0 / 255.0 + 1e-6
    # with per-eye frusta it renders each eye on its own, and says so
    caplog.clear()
    cli.main(["render", ply, "-o", out + "x.png", "--stereo", "--shared-bins", "--eye-tan-angles",
              "-0.5", "0.3", "0.4", "-0.4", "-0.3", "0.5", "0.4", "-0.4", *view])
    assert "stereo: per-eye render path" in caplog.text
    np.testing.assert_array_equal(load_png(out + "x.png"), load_png(out + "st.png"))

    cli.main(["render", ply, "-o", out + "before.png", *view])
    cli.main(["save-pose", ply, "--eye", "0", "1.6", "4", "--target", "0", "0.8", "0"])
    vr = str(scene_dir / "g_vr.json")
    floor = configs.load_vr_config(vr)
    # the camera lowered by --eye-height (1.5) along its own up axis
    np.testing.assert_allclose(floor[:3, 3], np.asarray([0.0, 1.6, 4.0]) - 1.5 * floor[:3, 1],
                               atol=1e-6)
    cli.main(["render", ply, "-o", out + "after.png", *view])
    assert np.abs(load_png(out + "after.png") - load_png(out + "before.png")).max() > 0.05

    # fit: targets rendered from the first two cameras.json views of the true
    # scene, a dimmed copy fitted back against the same cameras (the
    # <ply>_vr.json beside the scene is not applied)
    cli.main(["path", ply, "-o", str(tmp_path / "target.png"), *view])
    os.remove(str(tmp_path / "target_0002.png"))
    os.remove(str(tmp_path / "target_0003.png"))
    dim = load_gaussian_ply(ply, device="cpu")
    save_gaussian_ply(str(scene_dir / "dim.ply"), dataclasses.replace(dim, sh=dim.sh * 0.8))
    capsys.readouterr()
    cli.main(["fit", str(scene_dir / "dim.ply"), "--targets", str(tmp_path / "target_*.png"),
              "-o", str(tmp_path / "fitted.ply"), "--steps", "4", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (line["steps"], line["views"], line["splats"]) == (4, 2, 1000)
    assert np.isfinite(line["loss_last"]) and line["loss_last"] < line["loss_first"]
    # adaptive density against the same cameras.json: one event, at step 1
    cli.main(["fit", ply, "--targets", str(tmp_path / "target_*.png"), "-o",
              str(tmp_path / "fitted_adaptive.ply"), "--adaptive", "--steps", "2",
              "--densify-every", "1", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [e["step"] for e in line["densify_events"]] == [1]
    assert line["splats"] == line["densify_events"][0]["num_splats"] != 1000
