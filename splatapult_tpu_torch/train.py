"""Scene optimization: fit splat parameters to target images.

The reference is a forward-only viewer; differentiability is the entire point
of this re-architecture, and this module is the minimal production loop on
top of it: render -> pixel loss -> gradients to every splat parameter -> Adam
update, on one device.

This is deliberately a *library* (fit_scene), not a full trainer binary: the
splat count stays static. Adaptive density control (densify.py) runs on top of
_grad_stat_fit_steps' on-device gradient-norm accumulation. With a mesh,
fit_scene runs the multi-device steps of parallel/mesh.py.
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


def leaf_copy(scene: GaussianScene) -> GaussianScene:
    """A copy of the scene whose tensors are leaves that require grad."""
    return GaussianScene(**{
        f.name: getattr(scene, f.name).detach().clone().requires_grad_(True)
        for f in dataclasses.fields(scene)})


def detached(scene: GaussianScene) -> GaussianScene:
    """The scene's tensors without their autograd history (no copy)."""
    return GaussianScene(**{f.name: getattr(scene, f.name).detach()
                            for f in dataclasses.fields(scene)})


def _targets_on(targets, device) -> torch.Tensor:
    if not isinstance(targets, torch.Tensor):
        targets = torch.from_numpy(np.array(targets, dtype=np.float32))
    return targets.to(device=device, dtype=torch.float32)


_FIT_CHUNK = 32  # steps between two readbacks of the losses


def _grad_stat_fit_steps(scene: GaussianScene, optimizer: torch.optim.Optimizer,
                         cameras: Camera, targets, config: RenderConfig, steps: int,
                         callback: Optional[Callable] = None, first_step: int = 0):
    """``steps`` updates of the leaf scene in place that ALSO accumulate each
    splat's positional-gradient norm on the device -> (losses [steps] and
    gnorm_sum [N], both device tensors).

    After each step's gradient (the mean over the views, as in train_step)
    the L2 norm of every row of ``means.grad`` is added to an [N] float32
    accumulator, then the optimizer steps. Nothing is read back unless a
    ``callback(step, scene, loss)`` is given (as fit_scene's; ``step`` counts
    from ``first_step``). Adaptive density control (densify.py) takes its
    statistics from here.
    """
    acc = torch.zeros((scene.means.shape[0],), dtype=torch.float32,
                      device=scene.means.device)
    losses = []
    for i in range(steps):
        loss = _batch_value_and_grad(scene, cameras, targets, config)
        acc += torch.linalg.vector_norm(scene.means.grad, dim=1)
        optimizer.step()
        losses.append(loss)
        if callback is not None:
            callback(first_step + i, scene, float(loss))
    return torch.stack(losses), acc


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

    mesh: a DeviceMesh (parallel.make_render_mesh / make_pod_mesh; every
    rank calls fit_scene alike, with the same scene, cameras and targets)
    -> the sharded steps of parallel/mesh.py: tile rows over "tiles", views
    over "views", one gradient all-reduce a step; every rank returns the
    same scene and losses. param_shard=True (mesh only): ZeRO, each rank
    holds one chunk of the splats and its optimizer state
    (parallel.zero_fit_steps); ``optimizer`` is then called with that chunk.
    It reads the losses back once per chunk, so it takes no callback
    (ValueError). Both run the tiled pipeline and raise ValueError for
    supersample > 1.
    """
    if param_shard and mesh is None:
        raise ValueError("param_shard needs a mesh")
    if mesh is not None:
        return _fit_scene_sharded(scene, cameras, targets, config, steps, learning_rate,
                                  optimizer, mesh, callback, param_shard)
    params = leaf_copy(scene)
    opt = (default_optimizer(params, learning_rate) if optimizer is None
           else optimizer(params))
    targets = _targets_on(targets, params.means.device)

    losses = []
    if callback is not None:
        for step in range(steps):
            losses.append(float(train_step(params, opt, cameras, targets, config)))
            callback(step, params, losses[-1])
        return detached(params), losses
    done = 0
    while done < steps:
        n = min(_FIT_CHUNK, steps - done)
        chunk = [train_step(params, opt, cameras, targets, config) for _ in range(n)]
        losses.extend(torch.stack(chunk).cpu().tolist())
        done += n
    return detached(params), losses


def _fit_scene_sharded(scene, cameras, targets, config, steps, learning_rate, optimizer, mesh,
                       callback, param_shard):
    from splatapult_tpu_torch.parallel import mesh as pm

    if param_shard and callback is not None:
        raise ValueError(
            "param_shard does not take a per-step callback: the ZeRO loop reads the "
            "losses back once per chunk of steps")
    factory = optimizer or (lambda s: default_optimizer(s, learning_rate))
    targets = _targets_on(targets, scene.means.device)
    losses = []
    if param_shard:
        opt, done = factory, 0
        while done < steps:
            n = min(_FIT_CHUNK, steps - done)
            scene, opt, chunk = pm.zero_fit_steps(scene, cameras, targets, config, mesh, opt, n)
            losses.extend(chunk.cpu().tolist())
            done += n
        return scene, losses
    params = leaf_copy(scene)
    opt = factory(params)
    full = pm.shard_targets(targets, config, mesh)
    if callback is not None:
        for step in range(steps):
            loss, _ = pm.sharded_train_step(params, cameras, full, config, mesh, opt)
            losses.append(float(loss))
            callback(step, params, losses[-1])
        return detached(params), losses
    done = 0
    while done < steps:
        n = min(_FIT_CHUNK, steps - done)
        fit = pm.make_sharded_fit_steps(config, mesh, opt, n)
        losses.extend(fit(params, cameras, full).cpu().tolist())
        done += n
    return detached(params), losses
