"""Checkpoint/resume for scene parameters and optimizer state.

The reference's only persistence is the floorMat pose file and PLY write-back;
with optimization in the framework (train.py), step-level checkpointing
becomes meaningful. Two formats, both plain ``.npz`` archives of arrays (no
pickled objects, so ``numpy.load`` reads them with ``allow_pickle=False``):

- save_scene_npz / load_scene_npz — the scene (+ step): arrays ``step``
  (int64) and ``means``, ``sh``, ``opacities``, ``log_scales``, ``quats``
  (float32). The JAX package writes and reads the same format, so a file
  written by either package loads in the other.
- save_train_state / load_train_state — the scene and a ``torch.optim``
  optimizer's ``state_dict()`` in ``<directory>/step_<step:08d>.npz``:

    step                       int64
    scene/<field>              float32, the five scene fields
    optim/param_groups         a 0-d unicode array: the JSON of
                               ``state_dict()["param_groups"]`` (hyper-
                               parameters and parameter indices)
    optim/state/<i>/<key>      the per-parameter state tensors (Adam's
                               ``step``, ``exp_avg``, ``exp_avg_sq``), at
                               their own dtype

  The JAX package stores flattened optax pytree leaves instead; that layout
  does not carry over, so train states do not cross packages (scenes do).
  Restore with ``optimizer.load_state_dict(state)`` on an optimizer built
  over the loaded scene's tensors with the same parameter groups (e.g.
  train.default_optimizer).

PLY export (io.gaussians.save_gaussian_ply) remains the interchange format.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from splatapult_tpu_torch._device import DEFAULT_DEVICE, resolve_device
from splatapult_tpu_torch.io.gaussians import GaussianScene

_FIELDS = ("means", "sh", "opacities", "log_scales", "quats")


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def save_scene_npz(path: str, scene: GaussianScene, step: int = 0) -> None:
    np.savez_compressed(
        path,
        step=np.int64(step),
        **{f: _np(getattr(scene, f)).astype(np.float32) for f in _FIELDS},
    )


def load_scene_npz(path: str, device=DEFAULT_DEVICE):
    """-> (GaussianScene on ``device``, step)."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        scene = GaussianScene(**{f: torch.from_numpy(z[f].astype(np.float32)).to(device)
                                 for f in _FIELDS})
        step = int(z["step"]) if "step" in z else 0
    return scene, step


def _train_state_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}.npz")


def save_train_state(directory: str, scene: GaussianScene,
                     optimizer: torch.optim.Optimizer, step: int) -> None:
    """Checkpoint the scene and ``optimizer.state_dict()`` in one .npz; the
    format is in the module docstring."""
    os.makedirs(directory, exist_ok=True)
    state = optimizer.state_dict()
    arrays = {"step": np.int64(step),
              "optim/param_groups": np.asarray(json.dumps(state["param_groups"]))}
    for f in _FIELDS:
        arrays[f"scene/{f}"] = _np(getattr(scene, f)).astype(np.float32)
    for i, per_param in state["state"].items():
        for key, value in per_param.items():
            arrays[f"optim/state/{int(i)}/{key}"] = _np(value)
    np.savez_compressed(_train_state_path(directory, step), **arrays)


def load_train_state(directory: str, step: int, device=DEFAULT_DEVICE):
    """-> (scene on ``device``, optimizer state dict, step). The state dict's
    tensors are on the CPU; ``load_state_dict`` moves them to the
    parameters' device."""
    device = resolve_device(device)
    with np.load(_train_state_path(directory, step), allow_pickle=False) as z:
        scene = GaussianScene(**{
            f: torch.from_numpy(z[f"scene/{f}"]).to(device) for f in _FIELDS})
        groups = json.loads(str(z["optim/param_groups"]))
        for g in groups:
            if isinstance(g.get("betas"), list):
                g["betas"] = tuple(g["betas"])
        state = {}
        for name in z.files:
            if name.startswith("optim/state/"):
                i, key = name[len("optim/state/"):].split("/", 1)
                state.setdefault(int(i), {})[key] = torch.from_numpy(z[name])
        saved_step = int(z["step"])
    return scene, {"state": state, "param_groups": groups}, saved_step
