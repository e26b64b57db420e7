"""Carry parameters across from the JAX package without importing it.

The tests feed the same numpy arrays to both packages; these helpers build the
port's containers from those arrays (or from a JAX-side object whose fields
have been read with ``numpy.asarray`` / ``getattr``). Nothing here imports JAX
or the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from splatapult_tpu_torch._device import DEFAULT_DEVICE, resolve_device
from splatapult_tpu_torch.io.gaussians import GaussianScene
from splatapult_tpu_torch.render import Camera, RenderConfig

_SCENE_FIELDS = ("means", "sh", "opacities", "log_scales", "quats")


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(
        np.array(a, dtype=np.float32)).to(device)


def scene_from_numpy(scene, device=DEFAULT_DEVICE) -> GaussianScene:
    """A dict of arrays, or any object with the five GaussianScene fields
    convertible by numpy.asarray, -> GaussianScene on ``device``."""
    device = resolve_device(device)

    def field(name):
        return scene[name] if isinstance(scene, dict) else getattr(scene, name)

    return GaussianScene(**{k: _tensor(field(k), device) for k in _SCENE_FIELDS})


def scene_to_numpy(scene: GaussianScene) -> dict:
    """GaussianScene -> dict of the five fields as float32 numpy arrays (for
    comparing scenes across the two packages, e.g. after training steps)."""
    return {k: getattr(scene, k).detach().to("cpu", torch.float32).numpy()
            for k in _SCENE_FIELDS}


def camera_from_numpy(cam_to_world, proj, device=DEFAULT_DEVICE) -> Camera:
    """[4, 4] (or [V, 4, 4]) camera-to-world and projection arrays -> Camera."""
    device = resolve_device(device)
    return Camera(cam_to_world=_tensor(cam_to_world, device),
                  proj=_tensor(proj, device))


def config_from_jax(cfg) -> RenderConfig:
    """Field-by-field copy of a JAX-package RenderConfig (any object carrying
    the same attribute names) -> the port's RenderConfig."""
    return RenderConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(RenderConfig)
    })
