"""PyTorch port vs. the JAX package: adaptive density control (densify.py:
densify_and_prune, train._grad_stat_fit_steps, fit_scene_adaptive) on the CPU.

Tolerances. densify_and_prune: bit for bit, every field row for row, and the
stats equal — both packages compute alpha, the scales, the extent, the clone
offsets and the children in float64 with the same operations in the same
order, and draw the split offsets from the same numpy Generator. The
grad-statistics chunk: losses within rtol 1e-4, the accumulated norms within
1e-4 of their largest value, ``means`` after the chunk within atol 1e-5 (the
tolerances of test_torch_train.py: the composite backward sums in another
order, and Adam divides by the root of the squared gradient).

After the first densify event the port differs from the JAX package on
purpose, so no JAX adaptive run past it is an oracle:
- the optimizer state is carried through the row map, where the JAX package
  re-initialises Adam on every chunk (splatapult_tpu/densify.py:231);
- the capacity is calibrated again after every event, where the JAX CLI
  calibrates once before the splat count changes (splatapult_tpu/cli.py:399).
Each has its own test here.
"""

import concurrent.futures
import dataclasses
import importlib

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from splatapult_tpu.core import transforms as jT
from splatapult_tpu.densify import DensifyConfig as JDensifyConfig
from splatapult_tpu.densify import densify_and_prune as jdensify_and_prune
from splatapult_tpu.io.gaussians import GaussianScene as JGaussianScene
from splatapult_tpu.io.gaussians import make_debug_scene as jmake_debug_scene
from splatapult_tpu.io.synth import make_garden_scene as jmake_garden_scene
from splatapult_tpu.render import Camera as JCamera
from splatapult_tpu.render import RenderConfig as JRenderConfig
from splatapult_tpu.render import render as jrender
from splatapult_tpu.train import _grad_stat_fit_steps as j_grad_stat_fit_steps

import splatapult_tpu_torch as st
from splatapult_tpu_torch import convert, densify, train
from splatapult_tpu_torch.core import transforms as tT
from splatapult_tpu_torch.ops.tiled import composite_tiled

# One thread for torch: the suite runs several worker processes per machine,
# and an oversubscribed intra-op thread pool slows every worker down.
torch.set_num_threads(1)

R = importlib.import_module("splatapult_tpu_torch.render")  # the package re-exports render()
FIELDS = ("means", "sh", "opacities", "log_scales", "quats")
JAX_FAST_COMPILE = {"xla_backend_optimization_level": 0}
CHUNK = 2  # steps of the grad-statistics chunk


def _garden_case(n=3000, seed=4):
    """A garden of n splats, 35 of them transparent, and grad norms with
    ties (rounded), a few of them not finite."""
    scene = jmake_garden_scene(n, seed=seed)
    ops = np.asarray(scene.opacities).copy()
    ops[5:40] = -8.0
    rng = np.random.default_rng(seed)
    g = np.round(rng.lognormal(-9.0, 1.0, n), 6)
    g[:5] = [np.nan, np.inf, -np.inf, np.nan, 0.0]
    return dataclasses.replace(scene, opacities=jnp.asarray(ops)), g


def _debug_mix():
    """The debug scene with two hot splats, one tiny (clone), one large
    (split), and three transparent ones (prune), one of them hot."""
    scene = jmake_debug_scene()
    n = scene.num_gaussians
    ls = np.asarray(scene.log_scales).copy()
    ls[0, :] = -6.0
    ls[1, :] = [2.0, 0.5, -1.0]
    ops = np.asarray(scene.opacities).copy()
    ops[5:8] = -12.0
    g = np.zeros(n)
    g[0], g[1], g[6] = 10.0, 10.0, 10.0
    return (dataclasses.replace(scene, log_scales=jnp.asarray(ls), opacities=jnp.asarray(ops)),
            g)


# max_splats = the 2965 kept + 29: the greedy pick (by descending norm, ties
# in np.argsort's order) reaches a split with one unit left, skips it, and
# takes the first clone after it
BUDGET = 29
DENSIFY_CASES = {
    "percentile": (_garden_case, JDensifyConfig()),
    "absolute": (_garden_case, JDensifyConfig(grad_threshold=3e-4, scale_split=0.05)),
    "clone_split_mix": (_debug_mix, JDensifyConfig(grad_threshold=5.0, split_factor=2.0)),
    "budget": (_garden_case, JDensifyConfig(grad_percentile=80.0, scale_split=0.05,
                                            max_splats=2965 + BUDGET)),
    "prune_only": (_debug_mix, JDensifyConfig(grad_threshold=np.inf)),
}


@pytest.mark.parametrize("case", sorted(DENSIFY_CASES))
def test_densify_and_prune_bit_equal_to_jax(case):
    make, jcfg = DENSIFY_CASES[case]
    jscene, g = make()
    want, want_stats = jdensify_and_prune(jscene, g, jcfg)
    scene = convert.scene_from_numpy(jscene, device="cpu")
    cfg = densify.DensifyConfig(**dataclasses.asdict(jcfg))
    got, stats, row_map = densify.densify_and_prune(scene, torch.from_numpy(g), cfg,
                                                    return_row_map=True)
    assert stats == want_stats and stats["pruned"] > 0
    assert (stats["cloned"] + stats["split"] == 0) == (case == "prune_only")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    # the row map: survivors copy their old row, the children follow them
    n_kept = int((row_map >= 0).sum())
    assert row_map.shape == (stats["num_splats"],) and (row_map[n_kept:] == -1).all()
    for f in FIELDS:
        assert torch.equal(getattr(got, f)[:n_kept], getattr(scene, f)[row_map[:n_kept]])
    if case == "budget":  # every unit of the budget spent, on both kinds
        assert stats["cloned"] + 2 * stats["split"] == BUDGET and stats["split"] > 0


def test_percentile_matches_numpy():
    """The threshold equals np.percentile, at the edges of the virtual index
    too (a sort and an index: torch.quantile refuses more than 2^24 values)."""
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 1000):
        v = rng.standard_normal(n)
        for q in (0.0, 37.3, 50.0, 97.0, 99.9, 100.0):
            assert float(densify._percentile_linear(torch.from_numpy(v), q)) == np.percentile(
                v, q), (n, q)


def _fit_case():
    """Debug scene, two 32 x 32 views, targets rendered from the true scene;
    the start is a perturbed copy (test_torch_train.py's fit case)."""
    true = jmake_debug_scene()
    cams = [JCamera.from_fov(
        jT.look_at(eye=[np.cos(a) * 1.8, 1.0, np.sin(a) * 1.8], target=[0.3, 0.3, 0.3],
                   up=[0, 1, 0]), fovy=np.pi / 4, width=32, height=32)
        for a in np.linspace(0.3, 1.5, 2)]
    jcams = JCamera(cam_to_world=jnp.stack([c.cam_to_world for c in cams]),
                    proj=jnp.stack([c.proj for c in cams]))
    rng = np.random.default_rng(0)
    start = JGaussianScene(
        means=true.means + jnp.asarray(rng.normal(0, 0.03, (16, 3)), jnp.float32),
        sh=true.sh + jnp.asarray(rng.normal(0, 0.2, (16, 3, 16)), jnp.float32),
        opacities=true.opacities, log_scales=true.log_scales, quats=true.quats)
    jcfg = JRenderConfig(width=32, height=32, pipeline="tiled", tile_size=16, tile_block=8,
                         max_instance_mult=20)
    return true, start, jcams, jcfg


@pytest.fixture(scope="module")
def chunk():
    """One grad-statistics chunk of CHUNK steps from the same start towards
    targets the port renders from the true scene: the JAX package's (one
    compiled program, compiled in a second thread while this one runs the
    port) and the port's; then the port's fit_scene_adaptive over CHUNK + 1
    steps, its first event at the end of the same chunk, with hooks that keep
    the optimizer's state before and after the event."""
    true, start, jcams, jcfg = _fit_case()
    scene, cams, cfg = (convert.scene_from_numpy(start, device="cpu"),
                        convert.camera_from_numpy(np.asarray(jcams.cam_to_world),
                                                  np.asarray(jcams.proj), device="cpu"),
                        convert.config_from_jax(jcfg))
    true_port = convert.scene_from_numpy(true, device="cpu")
    with torch.no_grad():
        targets = torch.stack([st.render(true_port, st.Camera(cam_to_world=m, proj=p), cfg)
                               for m, p in zip(cams.cam_to_world, cams.proj)])
    opt = optax.adam(2e-2)
    jax_chunk = jax.jit(lambda s, t: j_grad_stat_fit_steps(s, opt.init(s), jcams, t, jcfg, opt,
                                                           CHUNK),
                        compiler_options=JAX_FAST_COMPILE)
    kept = {}

    def factory(p):
        kept["opt"] = densify.uniform_adam(p, 2e-2)
        return kept["opt"]

    def state_of(p):
        return {f: {k: v.clone() for k, v in kept["opt"].state[getattr(p, f)].items()}
                for f in FIELDS}

    def on_step(step, p, loss):
        if step == CHUNK - 1:
            kept["before"] = state_of(p)

    def on_event(event, p, config):
        kept.update(after=state_of(p), event_config=config, event_scene=st.GaussianScene(
            **{f: getattr(p, f).detach().clone() for f in FIELDS}))

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        exe = pool.submit(lambda: jax_chunk.lower(start, targets.numpy()).compile())
        params = train.leaf_copy(scene)
        losses, gnorm = train._grad_stat_fit_steps(
            params, densify.uniform_adam(params, 2e-2), cams, targets, cfg, CHUNK)
        fitted, ad_losses, events = densify.fit_scene_adaptive(
            scene, cams, targets, cfg, steps=CHUNK + 1, densify_every=CHUNK,
            densify_stop=CHUNK, learning_rate=2e-2, optimizer=factory, callback=on_step,
            on_event=on_event)
        jout, _, jlosses, jgnorm = jax.tree.map(np.asarray,
                                                exe.result()(start, targets.numpy()))
    return {"jax": (jout, jlosses, jgnorm), "port": (train.detached(params), losses, gnorm),
            "adaptive": (fitted, ad_losses, events), "kept": kept}


def test_grad_stat_chunk_matches_jax(chunk):
    jout, jlosses, jgnorm = chunk["jax"]
    out, losses, gnorm = chunk["port"]
    assert losses.shape == (CHUNK,) and gnorm.shape == (16,) and gnorm.dtype == torch.float32
    np.testing.assert_allclose(losses.numpy(), jlosses, rtol=1e-4)
    assert jgnorm.max() > 0 and np.isfinite(gnorm.numpy()).all()
    assert np.abs(gnorm.numpy() - jgnorm).max() <= 1e-4 * jgnorm.max()
    np.testing.assert_allclose(out.means.numpy(), jout.means, rtol=0, atol=1e-5)
    # the adaptive fit's first chunk is this chunk
    assert chunk["adaptive"][1][:CHUNK] == losses.tolist()


def test_first_event_equals_densify_of_the_chunk_and_jax(chunk):
    jout, _, jgnorm = chunk["jax"]
    out, _, gnorm = chunk["port"]
    fitted, losses, events = chunk["adaptive"]
    _, want_stats = jdensify_and_prune(jout, jgnorm / CHUNK, JDensifyConfig())
    want, stats = densify.densify_and_prune(out, gnorm / CHUNK)
    assert len(events) == 1 and events[0] == {**want_stats, "step": CHUNK}
    assert stats == want_stats and stats["cloned"] + stats["split"] > 0
    got = chunk["kept"]["event_scene"]
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert len(losses) == CHUNK + 1 and np.isfinite(losses).all()
    assert fitted.num_gaussians == stats["num_splats"] and not fitted.means.requires_grad


def test_adam_state_is_carried_through_the_row_map(chunk):
    """Survivors keep their moments, children start from zeros, the step
    count is kept. (The JAX package re-initialises Adam on every chunk,
    splatapult_tpu/densify.py:231, so it is no oracle here.)"""
    out, _, gnorm = chunk["port"]
    _, stats, row_map = densify.densify_and_prune(out, gnorm / CHUNK, return_row_map=True)
    before, after = chunk["kept"]["before"], chunk["kept"]["after"]
    kept = row_map >= 0
    assert 0 < int(kept.sum()) < len(row_map)
    for f in FIELDS:
        assert torch.equal(after[f]["step"], before[f]["step"])
        assert float(after[f]["step"]) == CHUNK
        for k in ("exp_avg", "exp_avg_sq"):
            assert after[f][k].shape[0] == stats["num_splats"]
            assert torch.equal(after[f][k][kept], before[f][k][row_map[kept]]), (f, k)
            assert (after[f][k][~kept] == 0).all(), (f, k)
            assert float(before[f][k].abs().max()) > 0.0


def test_capacity_is_recalibrated_after_an_event():
    """An event that prunes half the splats (transparent ones, which make no
    tile instance) halves N but not the demand: the capacity calibrated once
    (a multiple of N) drops instances afterwards, the port's calibration
    after the event drops none. (The JAX CLI calibrates once,
    splatapult_tpu/cli.py:399.)"""
    rng = np.random.default_rng(6)
    n = 8000
    quats = rng.standard_normal((n, 4))
    opacities = rng.uniform(0, 3, n)
    opacities[::2] = -12.0  # sigmoid ~ 6e-6: under prune_alpha and the 1/256 cutoff
    scene = convert.scene_from_numpy(dict(
        means=rng.uniform(-1, 1, (n, 3)), sh=rng.standard_normal((n, 3, 1)) * 0.5,
        opacities=opacities, log_scales=rng.uniform(-3.0, -2.2, (n, 3)),
        quats=quats / np.linalg.norm(quats, axis=-1, keepdims=True)), device="cpu")
    cam = st.Camera.from_fov(tT.look_at(eye=[0, 0.5, 3.0], target=[0, 0, 0], up=[0, 1, 0]),
                             fovy=np.pi / 4, width=64, height=48, device="cpu")
    cfg = st.calibrate_config(scene, cam, st.RenderConfig(
        width=64, height=48, pipeline="tiled", tile_size=8, tile_block=8, forward_only=False))
    with torch.no_grad():
        target = st.render(scene, cam, cfg)
    seen = {}
    _, _, events = densify.fit_scene_adaptive(
        scene, cam, target[None], cfg, steps=2, densify_every=1,
        densify=densify.DensifyConfig(grad_threshold=np.inf),
        on_event=lambda ev, p, c: seen.update(config=c, scene=st.GaussianScene(
            **{f: getattr(p, f).detach().clone() for f in FIELDS})))
    assert events == [{"pruned": n // 2, "cloned": 0, "split": 0, "num_splats": n // 2,
                       "step": 1}]

    def culled(c):
        with torch.no_grad():
            d = R.prepare_splats(seen["scene"], cam, c, sort=False)
            return int(composite_tiled(d, c, return_aux=True)[1]["num_culled_instances"])

    assert culled(cfg) > 0
    assert seen["config"].max_instance_mult > cfg.max_instance_mult
    assert culled(seen["config"]) == 0


def test_fit_scene_adaptive_options():
    """bucket (scene padding for XLA's compiled programs) is not ported; the
    default optimizer is uniform Adam; no event after densify_stop."""
    true, start, jcams, jcfg = _fit_case()
    scene = convert.scene_from_numpy(start, device="cpu")
    cams = convert.camera_from_numpy(np.asarray(jcams.cam_to_world), np.asarray(jcams.proj),
                                     device="cpu")
    cfg = convert.config_from_jax(jcfg)
    targets = np.zeros((2, 32, 32, 4), np.float32)
    with pytest.raises(NotImplementedError, match="queue 1 item 16"):
        densify.fit_scene_adaptive(scene, cams, targets, cfg, steps=2, bucket=1.3)
    opt = densify.uniform_adam(train.leaf_copy(scene), 1e-2)
    assert len(opt.param_groups) == 1 and opt.param_groups[0]["lr"] == 1e-2
    assert opt.param_groups[0]["betas"] == (0.9, 0.999) and opt.param_groups[0]["eps"] == 1e-8
    _, losses, events = densify.fit_scene_adaptive(scene, cams, targets, cfg, steps=3,
                                                   densify_every=1, densify_stop=1)
    assert len(losses) == 3 and [e["step"] for e in events] == [1]
