"""Adaptive density control: clone / split / prune during scene fitting.

The reference viewer consumes scenes the INRIA trainer produced; this module
is the trainer-side densification loop those scenes were made with, on top of
train._grad_stat_fit_steps: splats whose accumulated positional-gradient norm
is high are under-reconstructing — CLONE them where they are small (coverage
gap) and SPLIT them where they are large (over-stretched blob); splats whose
opacity has collapsed are PRUNED (INRIA 3DGS section 5.2).

The gradient statistics accumulate on the device inside the fit chunks (an
[N] float32 sum, no per-step readback). The reshaping runs on the scene's
device too, in float64 where the JAX package computes in float64, so the masks
and the children match it bit for bit; only the counts come back to the host,
plus, when ``max_splats`` binds, the hot splats' norms for the greedy pick,
which stays in numpy (np.argsort's tie order is part of the result).

fit_scene_adaptive differs from the JAX package's on purpose in two places
(ROADMAP queue 3):
- the optimizer state is carried across a densify event through the row map
  (survivors keep their moments, children start from zeros, the step count
  is kept), where the JAX package re-initialises Adam on every chunk
  (splatapult_tpu/densify.py:231);
- the capacity (``max_instance_mult``) is calibrated again after every event:
  it is a multiple of N, so an event that prunes lowers the capacity while
  the demand stays, and a multiplier calibrated once would drop instances
  (the JAX CLI calibrates once, splatapult_tpu/cli.py:397-399).
It also does not pad the scene onto a geometric grid of sizes (the JAX
package's ``bucket``): that reuses compiled XLA programs, and eager PyTorch
compiles nothing (ROADMAP queue 1 item 16).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from splatapult_tpu_torch import train
from splatapult_tpu_torch.io.gaussians import GaussianScene
from splatapult_tpu_torch.render import Camera, RenderConfig, calibrate_config

_FIELDS = ("means", "sh", "opacities", "log_scales", "quats")


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    """INRIA-style adaptive-density schedule knobs (the JAX package's).

    grad_threshold: mean positional-grad norm above which a splat densifies
        (None: use ``grad_percentile`` instead — the top q % densify, which
        sidesteps the units of the fit loop's gradients).
    scale_split: world-space scale above which a hot splat SPLITS instead of
        cloning (None = scene-extent / 100, from the live scene).
    split_factor: children scales = parent / split_factor (INRIA: 1.6).
    prune_alpha: sigmoid(opacity) below this is pruned.
    max_splats: hard capacity cap; densification stops adding above it.
    """

    grad_threshold: Optional[float] = None
    grad_percentile: float = 97.0
    scale_split: Optional[float] = None
    split_factor: float = 1.6
    prune_alpha: float = 1.0 / 255.0
    max_splats: int = 8_000_000


def _cross(a, b):
    """Row-wise cross product of [M, 3] tensors, one rounding per product and
    per difference, in numpy.cross's order."""
    a0, a1, a2 = a.unbind(1)
    b0, b1, b2 = b.unbind(1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=1)


def _quat_rotate(quats, v):
    """Rotate [M, 3] vectors by [M, 4] (w, x, y, z) quaternions, float64, in
    the JAX package's order of operations (its numpy _quat_rotate)."""
    norm = torch.linalg.vector_norm(quats, dim=1, keepdim=True)
    q = quats / torch.clamp_min(norm, 1e-12)
    w, xyz = q[:, :1], q[:, 1:]
    t = 2.0 * _cross(xyz, v)
    return v + w * t + _cross(xyz, t)


def _percentile_linear(values: torch.Tensor, q: float) -> torch.Tensor:
    """np.percentile(values, q) (method "linear") of a 1-D float64 tensor,
    bit for bit, as a 0-d tensor on its device. A sort and an index (where
    torch.quantile refuses more than 2^24 elements); the virtual index is
    numpy's, computed from the count alone."""
    n = values.numel()
    ordered = torch.sort(values).values
    vi = (n - 1) * np.true_divide(q, np.float64(100))
    if vi >= n - 1:
        lo = hi = n - 1
    elif vi < 0:
        lo = hi = 0
    else:
        lo = int(np.floor(vi))
        hi = lo + 1
    gamma = vi - np.floor(vi)  # where lo == hi, b - a is 0 and gamma no matter
    a, b = ordered[lo], ordered[hi]
    diff = b - a
    if gamma >= 0.5:
        return b - diff * float(1 - gamma)
    return a + diff * float(gamma)


def _greedy_pick(g_cat: np.ndarray, is_split: np.ndarray, budget: int) -> np.ndarray:
    """Positions into the hot list picked under ``budget`` (a clone costs 1,
    a split 2), in the order np.argsort(-g) visits them: the JAX package's
    greedy loop, in closed form. Every candidate is taken until the first one
    that does not fit; after it only a clone can still fit, when exactly one
    unit is left, and then only the first clone that follows."""
    order = np.argsort(-g_cat)
    cost = np.where(is_split[order], 2, 1)
    total = np.cumsum(cost)
    stop = int(np.searchsorted(total, budget, side="right"))
    picked = order[:stop]
    left = budget - (int(total[stop - 1]) if stop else 0)
    if left == 1:
        clones_after = np.flatnonzero(cost[stop:] == 1)
        if clones_after.size:
            picked = np.append(picked, order[stop + clones_after[0]])
    return picked


def densify_and_prune(scene: GaussianScene, grad_norms,
                      config: DensifyConfig = DensifyConfig(),
                      rng: Optional[np.random.Generator] = None,
                      return_row_map: bool = False):
    """One adaptive-density pass -> (new_scene, stats dict), or with
    ``return_row_map`` (new_scene, stats, row_map): for each new row the
    index of the old row it copies, -1 for a clone or split child.

    grad_norms: [N] mean positional-gradient norms (a tensor on any device,
    or an array), e.g. fit_scene_adaptive's accumulator over a chunk divided
    by its step count. rng: the numpy Generator of the split children's
    offsets (default: a fresh np.random.default_rng(0) on each call, as the
    JAX package's).

    Semantics (INRIA 3DGS section 5.2), row for row the JAX package's
    densify_and_prune:
      - prune:  sigmoid(opacity) < prune_alpha
      - hot:    grad_norms over the threshold (absolute, or percentile of the
        finite norms)
      - clone:  hot and max world scale <= scale_split — duplicated, offset
        half its largest scale along its own major axis
      - split:  hot and max scale > scale_split — two children sampled from
        the parent's Gaussian, scales / split_factor; the parent removed.
    The new rows: the kept rows that are not split parents in their order,
    the clone children, then the split children of the first draw and of the
    second.
    """
    rng = rng if rng is not None else np.random.default_rng(0)
    s = {k: getattr(scene, k).detach() for k in _FIELDS}
    dev = s["means"].device
    n = s["means"].shape[0]
    if not torch.is_tensor(grad_norms):
        grad_norms = torch.from_numpy(np.asarray(grad_norms, np.float64))
    g = grad_norms.detach().to(device=dev, dtype=torch.float64).reshape(-1)
    assert g.shape[0] == n, (g.shape, n)

    alpha = 1.0 / (1.0 + torch.exp(-s["opacities"].double()))
    keep = alpha >= config.prune_alpha
    if config.grad_threshold is not None:
        hot = g >= config.grad_threshold
    else:
        finite = g[torch.isfinite(g)]
        thr = (_percentile_linear(finite, config.grad_percentile) if finite.numel()
               else torch.tensor(float("inf"), dtype=torch.float64, device=dev))
        hot = g >= thr
    hot &= keep

    scales = torch.exp(s["log_scales"].double())
    if n:
        span = (s["means"].amax(0) - s["means"].amin(0)).double()
        extent = float(torch.sqrt(span[0] * span[0] + span[1] * span[1]
                                  + span[2] * span[2]))
    else:
        extent = 1.0
    scale_split = (config.scale_split if config.scale_split is not None
                   else 0.01 * max(extent, 1e-6))
    big = scales.amax(dim=1) > scale_split

    clone_idx = torch.nonzero(hot & ~big).flatten()
    split_idx = torch.nonzero(hot & big).flatten()
    n_keep = int(keep.sum())
    budget = max(config.max_splats - n_keep, 0)
    # splits add 2 children (parent removed: net +1), clones add 1
    if clone_idx.numel() + 2 * split_idx.numel() > budget:
        cat = torch.cat([clone_idx, split_idx])
        is_split = np.concatenate([np.zeros(clone_idx.numel(), bool),
                                   np.ones(split_idx.numel(), bool)])
        picked = _greedy_pick(g[cat].cpu().numpy(), is_split, budget)
        cat_np = cat.cpu().numpy()
        clone_idx = torch.from_numpy(cat_np[picked[~is_split[picked]]]).to(dev)
        split_idx = torch.from_numpy(cat_np[picked[is_split[picked]]]).to(dev)

    survive = keep.clone()
    survive[split_idx] = False
    kept_rows = torch.nonzero(survive).flatten()
    parts = {k: [v[kept_rows]] for k, v in s.items()}

    if clone_idx.numel():
        major = torch.argmax(s["log_scales"][clone_idx], dim=1)
        axis_local = torch.eye(3, dtype=torch.float64, device=dev)[major]
        offs = _quat_rotate(s["quats"][clone_idx].double(), axis_local)
        step = scales[clone_idx].amax(dim=1, keepdim=True) * 0.5
        child = {k: v[clone_idx] for k, v in s.items()}
        child["means"] = (child["means"].double() + offs * step).to(s["means"].dtype)
        for k in parts:
            parts[k].append(child[k])

    m = split_idx.numel()
    if m:
        for _ in range(2):
            eps = torch.from_numpy(rng.standard_normal((m, 3))).to(dev)
            local = eps * scales[split_idx]
            world = _quat_rotate(s["quats"][split_idx].double(), local)
            child = {k: v[split_idx] for k, v in s.items()}
            child["means"] = (child["means"].double() + world).to(s["means"].dtype)
            child["log_scales"] = (child["log_scales"].double()
                                   - np.log(config.split_factor)).to(
                s["log_scales"].dtype)
            for k in parts:
                parts[k].append(child[k])

    out = GaussianScene(**{k: torch.cat(v, dim=0) for k, v in parts.items()})
    stats = {
        "pruned": n - n_keep,
        "cloned": int(clone_idx.numel()),
        "split": int(m),
        "num_splats": out.num_gaussians,
    }
    if not return_row_map:
        return out, stats
    row_map = torch.cat([kept_rows, torch.full((clone_idx.numel() + 2 * m,), -1,
                                               dtype=kept_rows.dtype, device=dev)])
    return out, stats, row_map


def _take_rows(t: torch.Tensor, row_map: torch.Tensor) -> torch.Tensor:
    """Rows of ``t`` through the row map; rows mapped to -1 are zeros."""
    out = torch.zeros((row_map.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    have = row_map >= 0
    out[have] = t[row_map[have]]
    return out


def carry_optimizer_state(optimizer: torch.optim.Optimizer, old: GaussianScene,
                          new: GaussianScene, row_map: torch.Tensor) -> None:
    """Move ``optimizer`` from the leaves of ``old`` to those of ``new``, in
    place: every per-row state tensor of a parameter (a tensor of the
    parameter's shape: Adam's exp_avg, exp_avg_sq) is gathered through
    ``row_map`` — survivors keep their rows, children get zeros (INRIA's
    densification_postfix) — and every other entry (Adam's step) is kept."""
    swap = {id(getattr(old, k)): getattr(new, k) for k in _FIELDS}
    for group in optimizer.param_groups:
        group["params"] = [swap.get(id(p), p) for p in group["params"]]
    for k in _FIELDS:
        p_old = getattr(old, k)
        state = optimizer.state.pop(p_old, None)
        if state is None:
            continue
        optimizer.state[getattr(new, k)] = {
            name: (_take_rows(v, row_map) if torch.is_tensor(v) and v.shape == p_old.shape
                   else v)
            for name, v in state.items()}


def uniform_adam(scene: GaussianScene, learning_rate: float) -> torch.optim.Adam:
    """Adam at ``learning_rate`` for every field (betas 0.9/0.999, eps 1e-8):
    the JAX package's optax.adam(learning_rate), fit_scene_adaptive's default
    (not train.default_optimizer's per-field scaling)."""
    return torch.optim.Adam([getattr(scene, k) for k in _FIELDS], lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8)


def fit_scene_adaptive(scene: GaussianScene, cameras: Camera, targets, config: RenderConfig,
                       steps: int = 400, densify_every: int = 100,
                       densify_stop: Optional[int] = None, learning_rate: float = 1e-2,
                       densify: DensifyConfig = DensifyConfig(),
                       optimizer: Optional[Callable[[GaussianScene],
                                                    torch.optim.Optimizer]] = None,
                       bucket: Optional[float] = None, verbose: bool = False,
                       callback: Optional[Callable] = None,
                       on_event: Optional[Callable] = None):
    """fit_scene with INRIA-style adaptive density control -> (scene, losses,
    events).

    Chunks of ``densify_every`` steps accumulate each splat's positional-
    gradient norm on the device (train._grad_stat_fit_steps); after a chunk
    that ends at step ``done`` with ``done <= densify_stop`` (default: steps -
    densify_every) and ``done < steps``, densify_and_prune reshapes the scene
    with the chunk's mean norms, and ``events`` gets its stats with "step".
    At each event the optimizer's state is carried through the row map
    (carry_optimizer_state) and the capacity is calibrated again on the new
    scene and the same cameras (one scalar readback). The losses are read
    back once per chunk.

    The given scene is not modified. ``optimizer``: a factory over the leaf
    scene, as fit_scene's (default: uniform_adam at ``learning_rate``).
    ``callback(step, scene, loss)``: after every step, as fit_scene's.
    ``on_event(event, scene, config)``: after every event, with the new live
    parameters and the calibrated config. ``bucket`` (the JAX package's
    padding onto a grid of sizes) is not ported.
    """
    if bucket is not None:
        raise NotImplementedError(
            "fit_scene_adaptive(bucket=...) pads the scene so that XLA reuses "
            "compiled programs; eager PyTorch compiles nothing, so it is not "
            "ported (ROADMAP queue 1 item 16)")
    if densify_stop is None:
        densify_stop = steps - densify_every
    params = train.leaf_copy(scene)
    opt = (uniform_adam(params, learning_rate) if optimizer is None
           else optimizer(params))
    targets = train._targets_on(targets, params.means.device)

    losses, events = [], []
    done = 0
    while done < steps:
        n_steps = min(densify_every, steps - done)
        chunk, gsum = train._grad_stat_fit_steps(params, opt, cameras, targets, config,
                                                 n_steps, callback, first_step=done)
        losses.extend(chunk.cpu().tolist())
        done += n_steps
        if done <= densify_stop and done < steps:
            new, stats, row_map = densify_and_prune(
                train.detached(params), gsum / n_steps, densify, return_row_map=True)
            new = GaussianScene(**{k: getattr(new, k).requires_grad_(True) for k in _FIELDS})
            carry_optimizer_state(opt, params, new, row_map)
            params = new
            config = calibrate_config(train.detached(params), cameras, config)
            stats["step"] = done
            events.append(stats)
            if verbose:
                print(f"# densify @ {done}: {stats}")
            if on_event is not None:
                on_event(stats, params, config)
    return train.detached(params), losses, events
