"""Scene optimization: fit splat parameters to target images.

The reference is a forward-only viewer; differentiability is the entire point
of this re-architecture, and this module is the minimal production loop on
top of it: render -> pixel loss -> gradients to every splat parameter -> Adam
update, on one device.

This is deliberately a *library* (fit_scene), not a full trainer binary: the
splat count stays static. Adaptive density control and the multi-device
training steps are not ported yet (ROADMAP queue 1 items 5 and 7).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from splatapult_tpu_torch.io.gaussians import GaussianScene
from splatapult_tpu_torch.render import Camera, RenderConfig, render

# learning-rate scale per parameter group, in the spirit of the INRIA trainer:
# positions move slowly relative to appearance
LR_SCALE = {"means": 0.1, "sh": 1.0, "opacities": 1.0, "log_scales": 0.5, "quats": 0.1}


def l2_image_loss(img, target):
    return torch.mean((img - target) ** 2)


def _views(cameras: Camera):
    """A single or [V]-batched Camera -> list of single-view Cameras."""
    if cameras.cam_to_world.ndim == 2:
        return [cameras]
    return [Camera(cam_to_world=m, proj=p)
            for m, p in zip(cameras.cam_to_world, cameras.proj)]


def _leaves(scene: GaussianScene):
    return [getattr(scene, f.name) for f in dataclasses.fields(scene)]


def _batch_value_and_grad(scene: GaussianScene, cameras: Camera, targets,
                          config: RenderConfig):
    """Mean loss over the views -> device scalar; its gradient is left in the
    ``.grad`` of the scene's leaf tensors (any previous ``.grad`` is dropped).

    Per-view gradient ACCUMULATION rather than one graph over the view batch:
    the mean of per-view losses has the mean of per-view gradients, so this
    is the same update, and only one view's saved tensors (instance rows,
    composite output) are alive at a time.
    """
    leaves = _leaves(scene)
    for p in leaves:
        p.grad = None
    views = _views(cameras)
    loss_sum = None
    for cam, tgt in zip(views, targets):
        loss = l2_image_loss(render(scene, cam, config), tgt)
        loss.backward()
        loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
    v = len(views)
    for p in leaves:
        p.grad.div_(v)
    return loss_sum / v


def train_step(scene: GaussianScene, optimizer: torch.optim.Optimizer,
               cameras: Camera, targets, config: RenderConfig):
    """One update, in place, over a [V]-batched camera/target set -> the loss
    before the update as a device scalar (no readback)."""
    loss = _batch_value_and_grad(scene, cameras, targets, config)
    optimizer.step()
    return loss


def default_optimizer(scene: GaussianScene, learning_rate: float) -> torch.optim.Adam:
    """Adam (betas 0.9/0.999, eps 1e-8) with one parameter group per scene
    field at learning_rate * LR_SCALE[field]."""
    return torch.optim.Adam(
        [{"params": [getattr(scene, name)], "lr": learning_rate * scale}
         for name, scale in LR_SCALE.items()],
        betas=(0.9, 0.999), eps=1e-8)


_FIT_CHUNK = 32  # steps between two readbacks of the losses


def fit_scene(scene: GaussianScene, cameras: Camera, targets, config: RenderConfig,
              steps: int = 100, learning_rate: float = 1e-2,
              optimizer: Optional[Callable[[GaussianScene], torch.optim.Optimizer]] = None,
              mesh=None, callback: Optional[Callable] = None,
              param_shard: bool = False):
    """Optimize scene parameters against target images -> (scene, [losses]).

    The given scene is not modified: its tensors are copied into leaf
    parameters on their device, and the returned scene holds the fitted
    values (detached). ``optimizer`` is an optional factory taking that
    parameter scene and returning a torch optimizer over its tensors; the
    default is default_optimizer(scene, learning_rate).

    Without a callback the losses stay on the device and are read back once
    per chunk of _FIT_CHUNK steps, so the host never waits for a step. With
    ``callback(step, scene, loss)`` every step reads its loss back; the scene
    it is handed holds the live parameters after the update (their ``.grad``
    is that step's gradient), so copy what is to be kept.

    mesh / param_shard (the multi-device steps) are not ported yet.
    """
    if mesh is not None or param_shard:
        raise NotImplementedError(
            "fit_scene(mesh=..., param_shard=...) is not ported yet (ROADMAP "
            "queue 1 item 7: multi-device)")
    params = GaussianScene(**{
        f.name: getattr(scene, f.name).detach().clone().requires_grad_(True)
        for f in dataclasses.fields(scene)})
    opt = (default_optimizer(params, learning_rate) if optimizer is None
           else optimizer(params))
    if not isinstance(targets, torch.Tensor):
        targets = torch.from_numpy(np.array(targets, dtype=np.float32))
    targets = targets.to(device=params.means.device, dtype=torch.float32)

    def current():
        return GaussianScene(**{f.name: getattr(params, f.name).detach()
                                for f in dataclasses.fields(params)})

    losses = []
    if callback is not None:
        for step in range(steps):
            losses.append(float(train_step(params, opt, cameras, targets, config)))
            callback(step, params, losses[-1])
        return current(), losses
    done = 0
    while done < steps:
        n = min(_FIT_CHUNK, steps - done)
        chunk = [train_step(params, opt, cameras, targets, config) for _ in range(n)]
        losses.extend(torch.stack(chunk).cpu().tolist())
        done += n
    return current(), losses
