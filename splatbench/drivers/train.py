"""A trainer's loop in the shape of the 3DGS reference trainer's:
``train.train_step`` on one view a step, the views in a seeded order
reshuffled every epoch, ``train.default_optimizer`` (Adam), the capacity
calibrated once over the views, the losses read back every
``readback_every`` steps so that the host issues ahead.

Set-up builds the parameters (a seeded perturbation of the scene) and the
optimizer and drives them through ``check_steps`` steps of the window's own
call and feed, reading the first gradient from Adam's first moment after one
step and the parameters' change after them all; the reference follows the
same steps once the window has closed. ``warmup_steps`` more steps, then the
window: steps until ``--seconds`` have passed and the device has finished.
Traced: ``trace_steps`` steps timed without the profiler for
``timing_seconds``, once under it through ``train.train_step`` and once
through its parts in spans (the frame's, then loss, backward, optimizer).
"""

from __future__ import annotations

import importlib
import math
import statistics
import time

import torch
from torch.profiler import record_function

from splatbench import device as D
from splatbench import trace as TR
from splatbench import traffic
from splatbench.drivers.common import (
    dropped_instances, forward_in_spans, program_cameras, program_config)
from splatbench.reference import render as ref
from splatbench.scene import FIELDS, make_scene, perturbed


def start_params(ctx) -> dict:
    scene = make_scene(ctx.config["num_splats"], ctx.seed, ctx.device)
    return perturbed(scene, ctx.seed, ctx.traffic["perturb"])


def _norm(x) -> float:
    return float(torch.linalg.vector_norm(x.detach().double()))


def gaps(port: dict, reference: dict) -> dict:
    """The compared numbers: the worst relative gap of the losses, and of the
    norms by leaf of the first gradient and of the change after the checked
    steps, each gap over the larger of the leaf's reference norm and the
    median leaf's. Leaves whose reference gradient is under a thousandth of
    the median leaf's are left out of the change (Adam moves them by
    round-off)."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(port["losses"], reference["losses"]))
    g_ref = reference["grad_norms"]
    g_med = statistics.median(g_ref.values())
    grad_gap = max(abs(port["grad_norms"][k] - g_ref[k]) / max(g_ref[k], g_med) for k in g_ref)
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    c_ref = reference["change_norms"]
    c_med = statistics.median(c_ref[k] for k in moved)
    step_gap = max(abs(port["change_norms"][k] - c_ref[k]) / max(c_ref[k], c_med) for k in moved)
    out = {"loss_gap": loss_gap, "grad_gap": grad_gap, "step_gap": step_gap}
    return {k: (v if math.isfinite(v) else float("inf")) for k, v in out.items()}


def reference_steps(ctx, views, order, targets) -> dict:
    """The reference's losses, first gradient and change after the steps."""
    tr = ctx.traffic
    start = start_params(ctx)
    params = {k: v.double() for k, v in start.items()}
    lr = {k: tr["learning_rate"] * tr["lr_scale"][k] for k in FIELDS}
    refcfg = ref.ref_config(ctx.config)
    state, losses, grad_norms = {}, [], None
    for s, v in enumerate(order):
        loss, grads = ref.loss_and_grads(params, *views[v], targets[v], refcfg)
        losses.append(loss)
        if s == 0:
            grad_norms = {k: _norm(grads[k]) for k in FIELDS}
        ref.adam_update(params, grads, state, s + 1, lr, tuple(tr["betas"]), tr["eps"])
        del grads
    change = {k: _norm(params[k] - start[k].double()) for k in FIELDS}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


def run(ctx) -> dict:
    R = importlib.import_module("splatapult_tpu_torch.render")
    T = importlib.import_module("splatapult_tpu_torch.train")

    dev, cfg, tr = ctx.device, ctx.config, ctx.traffic
    mark = D.Marks()
    params = T.leaf_copy(R.GaussianScene(**start_params(ctx)))
    opt = T.default_optimizer(params, tr["learning_rate"])
    targets = traffic.targets(tr, cfg, ctx.seed, dev)
    views = traffic.cameras(tr, cfg)
    cams, batched = program_cameras(views, dev)
    mark("scene, optimizer, targets")
    rcfg = R.calibrate_config(T.detached(params), batched, program_config(cfg, tr, ctx.overrides))
    mark(f"calibration (max_instance_mult {rcfg.max_instance_mult:.4f})")
    order = traffic.epoch_order(ctx.seed, len(views))
    leaves = {k: getattr(params, k) for k in FIELDS}

    def step(v):
        return T.train_step(params, opt, cams[v], targets[v:v + 1], rcfg)

    before = {k: p.detach().clone() for k, p in leaves.items()}
    checked, losses = [], []
    for s in range(tr["check_steps"]):
        checked.append(next(order))
        losses.append(step(checked[-1]))
        if s == 0:
            beta1 = opt.param_groups[0]["betas"][0]
            grad_norms = {k: _norm(opt.state[p]["exp_avg"]) / (1.0 - beta1) if p in opt.state
                          else 0.0 for k, p in leaves.items()}
    port = {"losses": [float(x) for x in losses], "grad_norms": grad_norms,
            "change_norms": {k: _norm(p - before[k]) for k, p in leaves.items()}}
    del before
    for _ in range(tr["warmup_steps"]):
        step(next(order))
    D.sync(dev)
    out = {"setup_s": time.perf_counter() - ctx.t_start}
    mark("checked and warm-up steps")
    setup_peak = D.peak_bytes(dev)
    pixels = cfg["width"] * cfg["height"]

    if not ctx.trace:
        D.reset_peak(dev)
        shown, pending, window_losses = [], [], []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx.seconds:
            shown.append(next(order))
            pending.append(step(shown[-1]))
            if len(pending) == tr["readback_every"]:
                window_losses += torch.stack(pending).cpu().tolist()
                pending = []
        if pending:
            window_losses += torch.stack(pending).cpu().tolist()
        D.sync(dev)
        wall = time.perf_counter() - t0
        peak = D.peak_bytes(dev)
        out["window"] = {"seconds": wall, "steps": len(shown), "pixels": pixels, "peak_bytes": peak}
        peak = max(peak, setup_peak)
        bad_losses = sum(1 for x in window_losses if not math.isfinite(x))
        mark("window")
    else:
        k = tr["trace_steps"]
        path = [next(order) for _ in range(k)]
        now = {f: p.detach() for f, p in leaves.items()}
        refcfg = ref.ref_config(cfg)
        work = [ref.work_counts(now, *views[v], refcfg) for v in path]
        mark("work counts")
        rounds, t0 = 0, time.perf_counter()
        while rounds == 0 or time.perf_counter() - t0 < tr["timing_seconds"]:
            for v in path:
                step(v)
            D.sync(dev)
            rounds += 1
        iter_s = (time.perf_counter() - t0) / (rounds * k)

        def entry_steps():
            t = time.perf_counter()
            got = [step(v) for v in path]
            D.sync(dev)
            return time.perf_counter() - t, got

        (wall, got), entry = TR.profile(entry_steps, dev)

        def parts(v):
            for p in leaves.values():
                p.grad = None
            image = forward_in_spans(params, cams[v], rcfg)
            with record_function("loss"):
                loss = T.l2_image_loss(image, targets[v])
            with record_function("backward"):
                loss.backward()
            with record_function("optimizer"):
                opt.step()
            return loss.detach()

        _, spans = TR.profile(lambda: [parts(v) for v in path], dev)
        peak = D.peak_bytes(dev)
        shown = path
        bad_losses = sum(1 for x in torch.stack(got).cpu().tolist() if not math.isfinite(x))
        out["trace"] = {"entry": entry, "entry_wall_s": wall, "iters": k, "iter_s": iter_s,
                        "spans": spans, "span_iters": k, "work": work}
        out["breakdown"] = entry.breakdown()
        mark("timing and traces")

    drops = dropped_instances(T.detached(params), cams, rcfg, shown)
    out["attempted"] = len(shown)
    out["failed"] = bad_losses + sum(1 for v in shown if drops[v] > 0)
    out["device"] = D.describe(dev, peak)
    if ctx.trace:
        out["device"].update(busy_s=out["trace"]["entry"].busy_s(), window_s=wall)
    # the program's state goes before the reference runs
    del params, opt, leaves, cams, batched
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    mark("dropped instances")
    out["checks"] = gaps(port, reference_steps(ctx, views, checked, targets))
    mark("reference")
    return out
