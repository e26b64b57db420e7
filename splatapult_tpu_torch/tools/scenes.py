"""The benchmark scenes of the JAX repo's bench.py, and the view each is drawn from.

``make_scene`` is the counterpart of ``bench.make_scene`` (bench.py:23-44):
the round-1 synthetic, a uniform random ball, made with numpy from the seed
in the same order of draws, so the arrays are the JAX repo's bit for bit.
``make_bench_scene`` is ``bench.make_bench_scene`` (bench.py:46-54): "ball",
or "garden", the trained-scene stand-in of io/synth.make_garden_scene.
``bench_camera`` is the one view bench.py draws each from (bench.py:385-412):
the garden's first orbit camera, or for the ball the eye at (0, 0.8, 4.5)
looking at the origin, both with a 45 degree vertical field of view.
``perturbed`` is the training start that chip_smoke.py's training phases and
tools/scaling_model.py's measured step begin from.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from splatapult_tpu_torch._device import DEFAULT_DEVICE, resolve_device
from splatapult_tpu_torch.io.gaussians import GaussianScene, _scene_from_arrays

SCENES = ("ball", "garden")


def make_scene(num_splats: int, seed: int = 0, device=DEFAULT_DEVICE) -> GaussianScene:
    """The uniform random ball of radius 2 (SH degree 3, scales 1.5e-3 to
    1.1e-2), synthesized on the host and moved to ``device``."""
    rng = np.random.default_rng(seed)
    quats = rng.standard_normal((num_splats, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    means = rng.standard_normal((num_splats, 3)).astype(np.float32)
    means *= (rng.uniform(0, 1, (num_splats, 1)) ** (1 / 3)) / np.maximum(
        np.linalg.norm(means, axis=1, keepdims=True), 1e-6
    )
    sh = (rng.standard_normal((num_splats, 3, 16)) * 0.3).astype(np.float32)
    opacities = rng.uniform(-2.0, 3.0, (num_splats,)).astype(np.float32)
    log_scales = rng.uniform(-6.5, -4.5, (num_splats, 3)).astype(np.float32)
    return _scene_from_arrays(means * 2.0, sh, opacities, log_scales, quats,
                              resolve_device(device))


def make_bench_scene(kind: str, num_splats: int, seed: int = 0,
                     device=DEFAULT_DEVICE) -> GaussianScene:
    if kind == "ball":
        return make_scene(num_splats, seed, device)
    if kind != "garden":
        raise ValueError(f"scene {kind!r}: one of {SCENES}")
    from splatapult_tpu_torch.io.synth import make_garden_scene

    return make_garden_scene(num_splats, seed, device=device)


def bench_camera(kind: str, width: int, height: int, device=DEFAULT_DEVICE):
    """The single view bench.py renders ``kind`` from -> Camera."""
    from splatapult_tpu_torch.core import transforms as T
    from splatapult_tpu_torch.io.synth import garden_cameras
    from splatapult_tpu_torch.render import Camera

    if kind == "garden":
        return garden_cameras(1, width=width, height_px=height, device=device)
    return Camera.from_fov(T.look_at(eye=[0.0, 0.8, 4.5], target=[0, 0, 0], up=[0, 1, 0]),
                           fovy=np.pi / 4, width=width, height=height, device=device)


def perturbed(scene: GaussianScene, seed: int = 2) -> GaussianScene:
    """A training start: ``scene`` with seeded noise on its colours,
    opacities and positions."""
    dev = scene.means.device
    gen = torch.Generator(device=dev).manual_seed(seed)

    def noisy(t, sigma):
        return t + sigma * torch.randn(t.shape, generator=gen, device=dev)

    return dataclasses.replace(scene, sh=noisy(scene.sh, 0.1),
                               opacities=noisy(scene.opacities, 0.3),
                               means=noisy(scene.means, 0.005))
