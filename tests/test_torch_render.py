"""PyTorch port vs. the JAX package: the ported slice as a whole (one forward
render through the tiled pipeline), on the CPU.

Tolerance atol 3e-5 on the image: prepare agrees to ~1e-6 relative, the
composite to ~1e-5 (see test_torch_composite.py); a splat whose extent lands
on the other side of a tile edge changes only which tiles list it, not any
pixel (its weight there is below the 1/256 discard either way).
"""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from splatapult_tpu.core import transforms as jT
from splatapult_tpu.io.gaussians import make_debug_scene as jmake_debug_scene
from splatapult_tpu.io.synth import garden_cameras as jgarden_cameras
from splatapult_tpu.io.synth import make_garden_scene as jmake_garden_scene
from splatapult_tpu.render import Camera as JCamera
from splatapult_tpu.render import RenderConfig as JRenderConfig
from splatapult_tpu.render import calibrate_config as jcalibrate_config
from splatapult_tpu.render import render as jrender

import splatapult_tpu_torch as st
from splatapult_tpu_torch import convert
from splatapult_tpu_torch.core import transforms as tT
from splatapult_tpu_torch.io.gaussians import load_gaussian_ply, make_debug_scene, save_gaussian_ply
from splatapult_tpu_torch.io.synth import garden_cameras, make_garden_scene
from splatapult_tpu_torch.render import (
    PROFILES,
    apply_profile,
    bucket_capacity_mult,
    capacity_mult_for_demand,
    profile_name,
)
from splatapult_tpu_torch.utils.image import composite_to_rgb, load_png, save_png

# One thread for torch: the suite runs several worker processes per machine,
# and an oversubscribed intra-op thread pool slows every worker down.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")


def _port_side(jscene, jcam, jcfg):
    return (convert.scene_from_numpy(jscene, device="cpu"),
            convert.camera_from_numpy(np.asarray(jcam.cam_to_world), np.asarray(jcam.proj),
                                      device="cpu"),
            convert.config_from_jax(jcfg))


@pytest.fixture(scope="module")
def debug_case():
    jcam = JCamera.from_fov(
        jT.look_at(eye=[1.2, 1.1, 1.3], target=[0.3, 0.3, 0.3], up=[0, 1, 0]),
        fovy=np.pi / 4, width=128, height=128)
    jcfg = JRenderConfig(width=128, height=128, pipeline="tiled", tile_size=16,
                         tile_block=8, max_instance_mult=24)
    jscene = jmake_debug_scene()
    return jscene, jcam, jcfg, np.asarray(jrender(jscene, jcam, jcfg))


@pytest.fixture(scope="module")
def garden_case():
    jscene = jmake_garden_scene(2000, seed=0)
    jcam = jgarden_cameras(1, width=96, height_px=64)
    jcfg = JRenderConfig(width=96, height=64, pipeline="tiled", tile_size=16,
                         tile_block=8, max_instance_mult=4.0)
    return jscene, jcam, jcfg, np.asarray(jrender(jscene, jcam, jcfg))


def test_render_debug_scene_matches_jax(debug_case):
    jscene, jcam, jcfg, want = debug_case
    got = st.render(*_port_side(jscene, jcam, jcfg)).numpy()
    assert got.shape == want.shape == (128, 128, 4) and got[..., 3].max() > 0.9
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-5)


def test_render_debug_scene_matches_golden(debug_case):
    jscene, jcam, jcfg, _ = debug_case
    got = st.render(*_port_side(jscene, jcam, jcfg)).numpy()
    want = np.load(os.path.join(GOLDEN, "debug_tiled.npy")).astype(np.float32)
    np.testing.assert_allclose(got, want, atol=3e-3)  # f16 storage, as tests/test_golden.py


def test_render_garden_40k_matches_golden():
    scene = make_garden_scene(40_000, seed=0, device="cpu")
    cam = garden_cameras(1, width=320, height_px=192, device="cpu")
    cfg = st.RenderConfig(width=320, height=192, pipeline="tiled", tile_size=16,
                          tile_block=8, max_instance_mult=8)
    got = st.render(scene, cam, cfg).numpy()
    want = np.load(os.path.join(GOLDEN, "garden_40k_tiled.npy")).astype(np.float32)
    np.testing.assert_allclose(got, want, atol=3e-3)


def test_render_garden_matches_jax(garden_case):
    jscene, jcam, jcfg, want = garden_case
    got = st.render(*_port_side(jscene, jcam, jcfg)).numpy()
    assert got[..., 3].max() > 0.5
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-5)
    # pipeline="auto" resolves to tiled only from 4096 splats up: this
    # 2000-splat scene goes through the global pipeline, as in JAX
    scene, cam, cfg = _port_side(jscene, jcam, jcfg)
    auto = dataclasses.replace(cfg, pipeline="auto")
    got_auto = st.render(scene, cam, auto)
    assert torch.equal(got_auto, st.render(scene, cam, dataclasses.replace(cfg, pipeline="global")))
    want_auto = np.asarray(jrender(jscene, jcam, dataclasses.replace(jcfg, pipeline="auto")))
    np.testing.assert_allclose(got_auto.numpy(), want_auto, rtol=0, atol=3e-5)


def test_render_auto_is_tiled_for_large_scene():
    scene = make_garden_scene(5000, seed=1, device="cpu")
    cam = garden_cameras(1, width=96, height_px=64, device="cpu")
    cfg = st.RenderConfig(width=96, height=64, tile_size=16, tile_block=8, max_instance_mult=4.0)
    a = st.render(scene, cam, cfg)
    b = st.render(scene, cam, dataclasses.replace(cfg, pipeline="tiled"))
    assert torch.equal(a, b)


def test_camera_looking_away_renders_exactly_zero(debug_case):
    jscene, _, jcfg, _ = debug_case
    scene = convert.scene_from_numpy(jscene, device="cpu")
    cam = st.Camera.from_fov(
        tT.look_at(eye=[1.2, 1.1, 1.3], target=[3.0, 3.0, 3.0], up=[0, 1, 0]),
        fovy=np.pi / 4, width=128, height=128, device="cpu")
    img = st.render(scene, cam, convert.config_from_jax(jcfg))
    assert img.shape == (128, 128, 4) and float(img.abs().max()) == 0.0


def test_camera_helpers():
    c2w = tT.look_at(eye=[0.0, 0.5, 2.5], target=[0, 0, 0], up=[0, 1, 0])
    cam = st.Camera.from_fov(c2w, fovy=np.pi / 4, width=64, height=48, device="cpu")
    jcam = JCamera.from_fov(jT.look_at(eye=[0.0, 0.5, 2.5], target=[0, 0, 0], up=[0, 1, 0]),
                            fovy=np.pi / 4, width=64, height=48)
    np.testing.assert_allclose(cam.proj.numpy(), np.asarray(jcam.proj), rtol=1e-6)
    np.testing.assert_allclose(cam.eye.numpy(), [0.0, 0.5, 2.5])
    floor = np.eye(4, dtype=np.float32)
    floor[:3, 3] = [1.0, 2.0, 3.0]
    np.testing.assert_allclose(cam.with_floor_transform(floor).cam_to_world.numpy(),
                               np.asarray(jcam.with_floor_transform(floor).cam_to_world),
                               rtol=1e-6, atol=1e-6)


def test_calibrate_config_lands_on_same_bucket(garden_case):
    jscene, jcam, jcfg, _ = garden_case
    scene, cam, cfg = _port_side(jscene, jcam, jcfg)
    want = jcalibrate_config(jscene, jcam, jcfg).max_instance_mult
    assert st.calibrate_config(scene, cam, cfg).max_instance_mult == want
    # a [V]-batched camera takes the peak over the views
    jring = jgarden_cameras(3, width=96, height_px=64)
    ring = convert.camera_from_numpy(np.asarray(jring.cam_to_world), np.asarray(jring.proj),
                                     device="cpu")
    assert (st.calibrate_config(scene, ring, cfg).max_instance_mult
            == jcalibrate_config(jscene, jring, jcfg).max_instance_mult)


def test_capacity_arithmetic_matches():
    from splatapult_tpu.render import bucket_capacity_mult as jbucket
    from splatapult_tpu.render import capacity_mult_for_demand as jcap

    for m in (0.37, 1.0, 1.59, 6.0):
        assert bucket_capacity_mult(m) == jbucket(m)
    cfg, jcfg = st.RenderConfig(width=1920, height=1080), JRenderConfig(width=1920, height=1080)
    for demand, n in ((2_271_568, 1_500_000), (1_700_000, 1_000_000), (10, 16)):
        assert capacity_mult_for_demand(demand, n, cfg) == jcap(demand, n, jcfg)


def test_config_and_profiles_match():
    import importlib

    jr = importlib.import_module("splatapult_tpu.render")  # the package re-exports render()
    jfields = {f.name: f.default for f in dataclasses.fields(JRenderConfig)}
    tfields = {f.name: f.default for f in dataclasses.fields(st.RenderConfig)}
    assert jfields == tfields
    assert PROFILES == jr.PROFILES
    cfg = convert.config_from_jax(jr.apply_profile(JRenderConfig(), "production"))
    assert profile_name(cfg) == "production"
    assert profile_name(apply_profile(st.RenderConfig(), "exact")) == "exact"
    assert profile_name(dataclasses.replace(st.RenderConfig(), depth_bits=16)) == "custom"
    assert hash(cfg) == hash(dataclasses.replace(cfg))  # frozen and hashable


@pytest.mark.parametrize("knob", [
    {"packed_colors": True}, {"packed_feats16": True}, {"accum_dtype": "bfloat16"},
    {"supersample": 2}, {"sort_bands": 2}, {"pipeline": "global"},
], ids=lambda k: next(iter(k)))
def test_deferred_knobs_raise_not_implemented(knob):
    """Knobs of later slices raise naming their ROADMAP item (sort_bands, a
    TPU workaround that is not ported). The row layouts and bf16
    accumulation are ported: they render, near the exact image (JAX's
    packed_feats16 contract, tests/test_tiled.py; tests/test_torch_packed.py
    holds each against the JAX package). Supersampling and the global
    pipeline are ported: supersample=2 equals the 128x128 render box-filtered
    down, and the global pipeline agrees with the tiled one to the tiled
    kernel's tolerance (tests/test_torch_global.py holds both against the
    JAX package)."""
    scene = make_debug_scene(device="cpu")
    cam = st.Camera.from_fov(
        tT.look_at(eye=[1.2, 1.1, 1.3], target=[0.3, 0.3, 0.3], up=[0, 1, 0]),
        fovy=np.pi / 4, width=64, height=64, device="cpu")
    base = st.RenderConfig(width=64, height=64, pipeline="tiled", tile_size=16, tile_block=8)
    cfg = dataclasses.replace(base, **knob)
    if next(iter(knob)) in ("packed_colors", "packed_feats16", "accum_dtype"):
        img, exact = st.render(scene, cam, cfg), st.render(scene, cam, base)
        assert img.dtype == torch.float32 and float(img[..., 3].max()) > 0.5
        diff = (img - exact).abs()
        assert float(diff.max()) < 0.05 and float(diff.mean()) < 2e-3
        return
    if next(iter(knob)) == "supersample":
        img = st.render(scene, cam, cfg)
        hi = st.render(scene, cam, dataclasses.replace(base, width=128, height=128))
        assert img.shape == (64, 64, 4) and float(img[..., 3].max()) > 0.5
        np.testing.assert_allclose(img.numpy(), hi.reshape(64, 2, 64, 2, 4).mean(dim=(1, 3)),
                                   rtol=0, atol=1e-6)
        return
    if next(iter(knob)) == "pipeline":
        img, tiled = st.render(scene, cam, cfg), st.render(scene, cam, base)
        assert float(img[..., 3].max()) > 0.5
        diff = (img - tiled).abs()
        # the kernels' tolerance against their plain versions: the 1/256
        # discard can flip single (splat, pixel) pairs
        assert float(diff.max()) <= 5e-3 and float((diff > 1e-4).float().mean()) <= 1e-4
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        st.render(scene, cam, cfg)


def test_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card error cannot show")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_debug_scene()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        st.Camera.from_fov(np.eye(4), fovy=1.0, width=8, height=8)


def test_png_round_trip(tmp_path):
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (21, 34, 4)).astype(np.float32)
    img[..., :3] *= img[..., 3:]  # premultiplied
    path = str(tmp_path / "a.png")
    save_png(path, img, background=(0.2, 0.4, 0.6))
    back = load_png(path)
    want = composite_to_rgb(img, background=(0.2, 0.4, 0.6))
    assert back.shape == (21, 34, 3) and np.abs(back - want).max() <= 0.5 / 255 + 1e-6
    save_png(path, img, keep_alpha=True)
    rgba = load_png(path, premultiply=True)
    assert rgba.shape == (21, 34, 4) and np.abs(rgba - img).max() <= 2.0 / 255
    assert np.array_equal(load_png(path, flip=True), rgba[::-1])
    # a PNG written by another encoder (row filters on a smooth image) reads back equal
    from PIL import Image

    yy, xx = np.mgrid[0:40, 0:56]
    smooth = np.stack([xx * 4, yy * 6, (xx + yy) * 2], -1).astype(np.uint8)
    Image.fromarray(smooth, "RGB").save(path)
    np.testing.assert_array_equal((load_png(path) * 255 + 0.5).astype(np.uint8), smooth)


def test_ply_round_trip(tmp_path):
    scene = make_garden_scene(300, seed=5, device="cpu")
    path = str(tmp_path / "s.ply")
    save_gaussian_ply(path, scene)
    back = load_gaussian_ply(path, device="cpu")
    for f in ("means", "sh", "opacities", "log_scales", "quats"):
        assert torch.equal(getattr(back, f), getattr(scene, f)), f
    assert back.sh_degree == 3 and back.num_gaussians == 300
    nosh = load_gaussian_ply(path, use_full_sh=False, device="cpu")
    assert nosh.sh.shape == (300, 3, 1) and torch.equal(nosh.sh[..., 0], scene.sh[..., 0])
    # the JAX package reads the same file to the same arrays
    from splatapult_tpu.io.gaussians import load_gaussian_ply as jload

    jback = jload(path)
    np.testing.assert_array_equal(np.asarray(jback.sh), scene.sh.numpy())


def test_cli_synth_and_render_on_cpu(tmp_path):
    from splatapult_tpu_torch import cli

    ply, png = str(tmp_path / "g.ply"), str(tmp_path / "g.png")
    cli.main(["synth", "garden", "--splats", "3000", "-o", ply])
    cli.main(["render", ply, "-o", png, "--width", "96", "--height", "64", "--tile-size", "16",
              "--eye", "4.2", "1.6", "0", "--target", "0", "0.8", "0", "--device", "cpu"])
    img = load_png(png)
    assert img.shape == (64, 96, 3) and img.max() > 0.1


def test_cli_packed_fp16_render_and_production_bench_on_cpu(tmp_path):
    """render --packed-colors --fp16 runs through the plain path; bench
    --profile production refuses the CPU with its device error (it measures
    the GPU), not with NotImplementedError."""
    from splatapult_tpu_torch import cli

    ply, png = str(tmp_path / "g.ply"), str(tmp_path / "g.png")
    view = ["--width", "96", "--height", "64", "--tile-size", "16",
            "--eye", "4.2", "1.6", "0", "--target", "0", "0.8", "0", "--device", "cpu"]
    cli.main(["synth", "garden", "--splats", "3000", "-o", ply])
    cli.main(["render", ply, "-o", png, "--packed-colors", "--fp16", *view])
    packed = load_png(png)
    cli.main(["render", ply, "-o", png, *view])
    assert packed.shape == (64, 96, 3) and packed.max() > 0.1
    assert np.abs(packed - load_png(png)).max() <= 0.05  # JAX's bf16 tolerance
    with pytest.raises(SystemExit, match="GPU"):
        cli.main(["bench", ply, "--profile", "production", *view])


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "splatapult_tpu_torch")):
        if "_build" in os.path.relpath(root, REPO).split(os.sep):
            continue
        out += [os.path.join(root, f) for f in files if f.endswith((".py", ".cu", ".cuh"))]
    return out


def test_port_sources_import_no_jax():
    banned = re.compile(r"^\s*(import jax|from jax|import splatapult_tpu\b(?!_torch)|"
                        r"from splatapult_tpu\b(?!_torch)|.*\bsplatapult_tpu\.(?!\w*py\b))",
                        re.M)
    sources = _port_sources()
    assert len(sources) > 15
    for path in sources:
        text = open(path, encoding="utf-8").read()
        hits = [m.group(0).strip() for m in banned.finditer(text)
                if "splatapult_tpu/" not in m.group(0)]
        assert not hits, (os.path.relpath(path, REPO), hits)


def test_importing_the_port_loads_no_jax_module():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import splatapult_tpu_torch, splatapult_tpu_torch.cli, splatapult_tpu_torch.convert\n"
        "import splatapult_tpu_torch.io.synth, splatapult_tpu_torch.utils.image\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'splatapult_tpu' or m.startswith('splatapult_tpu.'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card exit cannot show")
    res = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and '"ok"' not in res.stdout
