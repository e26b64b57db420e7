"""The plain reference against the program on the CPU at a few thousand
splats: images, the loss and its gradients, Adam; and its chunking."""

from __future__ import annotations

import importlib

import pytest
import torch

from splatbench import traffic
from splatbench.drivers.common import image_errors, program_cameras, program_config
from splatbench.reference import render as ref
from splatbench.scene import FIELDS, make_scene, perturbed

R = importlib.import_module("splatapult_tpu_torch.render")
T = importlib.import_module("splatapult_tpu_torch.train")

W, H = 128, 96
BASE = {"width": W, "height": H, "tile_size": 32, "tile_block": 128, "alpha_cutoff": 1 / 256,
        "accum_dtype": "float32"}
PROFILES = {
    "exact": dict(BASE, depth_bits=32, packed_colors=False, early_stop_eps=0.0,
                  grad_sort_dtype="float32"),
    "production": dict(BASE, depth_bits=20, packed_colors=True, early_stop_eps=1e-4,
                       grad_sort_dtype="bfloat16"),
}
MIX = {"fovy": 0.7853981633974483, "near": 0.1, "far": 1000.0, "views": 3, "radius": 3.2,
       "height": 1.6, "target": [0.0, 0.8, 0.0], "forward_only": False}


@pytest.fixture(scope="module")
def scene():
    torch.set_num_threads(4)
    return make_scene(8000, 424242, torch.device("cpu"))


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_reference_image_is_the_programs(scene, profile):
    cfg = PROFILES[profile]
    views = traffic.ring(MIX, cfg)
    cams, batched = program_cameras(views, torch.device("cpu"))
    rcfg = R.calibrate_config(R.GaussianScene(**scene), batched, program_config(cfg, MIX, {}))
    for v, cam in enumerate(cams):
        img = R.render(R.GaussianScene(**scene), cam, rcfg)
        err = image_errors(img, ref.render(scene, *views[v], ref.ref_config(cfg)))
        assert err["img_err_mean"] < 2e-6 and err["img_err_p999"] < 5e-5, err
        assert float(img[..., 3].max()) > 0.5


def test_chunks_do_not_change_the_image(scene):
    cfg = ref.ref_config(PROFILES["production"])
    c2w, proj = traffic.ring(MIX, PROFILES["production"])[0]
    whole = ref.render(scene, c2w, proj, cfg, budget=1 << 30)
    small = ref.render(scene, c2w, proj, cfg, budget=64)
    assert torch.allclose(whole, small, rtol=0, atol=1e-12)


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_reference_loss_and_gradients_are_the_programs(scene, profile):
    cfg = PROFILES[profile]
    views = traffic.ring(MIX, cfg)
    start = perturbed(scene, 5, 0.01)
    target = traffic.targets(dict(MIX, target_grid=[3, 4]), cfg, 5, torch.device("cpu"))[0]
    cams, batched = program_cameras(views, torch.device("cpu"))
    params = T.leaf_copy(R.GaussianScene(**start))
    rcfg = R.calibrate_config(T.detached(params), batched, program_config(cfg, MIX, {}))
    loss = float(T._batch_value_and_grad(params, cams[0], target[None], rcfg))
    ref_loss, grads = ref.loss_and_grads(start, *views[0], target, ref.ref_config(cfg))
    assert abs(loss - ref_loss) <= 1e-5 * ref_loss
    tol = 4e-3 if profile == "production" else 2e-4  # the bf16 tail of production
    for k in FIELDS:
        g = getattr(params, k).grad.double()
        scale = float(grads[k].abs().max())
        assert float((g - grads[k]).abs().max()) <= tol * scale + 1e-12, k


def test_adam_is_torchs():
    torch.manual_seed(0)
    p = {"a": torch.randn(50, dtype=torch.float64), "b": torch.randn(7, 3, dtype=torch.float64)}
    mine = {k: v.clone() for k, v in p.items()}
    theirs = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    lr = {"a": 1e-3, "b": 5e-4}
    opt = torch.optim.Adam([{"params": [theirs[k]], "lr": lr[k]} for k in p], betas=(0.9, 0.999),
                           eps=1e-8)
    state = {}
    for step in range(1, 4):
        grads = {k: torch.randn_like(v) for k, v in p.items()}
        ref.adam_update(mine, grads, state, step, lr)
        for k in p:
            theirs[k].grad = grads[k].clone()
        opt.step()
    for k in p:
        assert torch.allclose(mine[k], theirs[k].detach(), rtol=0, atol=1e-12)
