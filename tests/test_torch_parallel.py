"""PyTorch port vs. the JAX package: multi-device rendering and training
(splatapult_tpu_torch/parallel/ against splatapult_tpu/parallel/), on the CPU.

The JAX package's small problem (tests/test_parallel.py): 64 px wide, tile
16, block 8, its random 48-splat scene (seed 5), two views; the height is 48,
which does not divide into 2 or 4 shards of 16-px tile rows, so every layout
pads. Inputs are made from numpy seeds and handed to both packages.

Two kinds of test:
- in this process, no process group: the layout functions, the per-band
  demands, the calibrated capacity and every rank's band image (the port's
  band function run for each rank in turn) against the JAX functions;
- spawned ranks (torch.multiprocessing, spawn, gloo on the CPU): one 4-rank
  world that runs every case on a (2 views, 2 tiles) and a (1, 4) mesh, and
  one 2-rank world brought up by initialize_distributed from torchrun's
  environment variables with make_pod_mesh. The rank bodies are this file's
  module-level functions; this file imports JAX only inside its fixtures, so
  the ranks never load it. Each rank pickles numpy results to a file; each
  world is joined with its own timeout, after which its ranks are killed.
  The ranks' results are held against the JAX package's UNSHARDED functions
  on the same inputs (tests/test_parallel.py holds JAX's sharded functions
  to those), and every rank's results must be the same.

The JAX references come from a few compiled programs in a module fixture
(each compiled in a thread while the next is traced, XLA's backend
optimisations off), while the spawned worlds run.

Tolerances, and why:
- layouts, pads, targets, demands: bit for bit (integers, copies);
- the calibrated max_instance_mult: equal (a function of the peak demand);
- images: atol 2e-5, the JAX tests' own (tests/test_parallel.py);
- losses rtol 1e-5, gradients within 2e-4 of each field's largest
  (tests/test_parallel.py): the band sums and the all-reduce add in another
  order. This is the case that tells a reduce-scatter backward of the
  feature gather (shard_prepare) from a slice of the local cotangent;
- the in-backward SH all-reduce (_psum_in_bwd): the marker's sums of small
  integers exactly; the step on a degree-3 scene (K = 16) of N - 1 splats
  (the row padding binds) against jax.value_and_grad as above; the
  schedule by the host clock (the marker's issue time against every
  accumulation into means.grad);
- fit_scene chunked against per-step: rtol 2e-5; ZeRO against the
  replicated sharded fit: losses rtol 2e-5, parameters rtol 1e-4 / atol
  2e-6 (the JAX package's own tolerances); ZeRO losses against the JAX
  fit_scene with optax.adam(1e-2): rtol 1e-4.
"""

import concurrent.futures
import dataclasses
import functools
import os
import pickle
import socket
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from splatapult_tpu_torch import convert, train
from splatapult_tpu_torch.core import transforms as tT
from splatapult_tpu_torch.parallel import distributed as PD
from splatapult_tpu_torch.parallel import mesh as PM
from splatapult_tpu_torch.render import Camera, RenderConfig, prepare_splats, render

torch.set_num_threads(1)

FIELDS = ("means", "sh", "opacities", "log_scales", "quats")
CFG = RenderConfig(width=64, height=48, pipeline="tiled", tile_size=16, tile_block=8,
                   max_instance_mult=20)
LAYOUTS = ("interleaved", "contiguous")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}  # (view shards, tile shards)
FIT_STEPS, ZERO_STEPS, ZERO_MORE = 3, 3, 2
WORLD_TIMEOUT_S = 120.0
JAX_FAST_COMPILE = {"xla_backend_optimization_level": 0}


def _scene_arrays(n=48, seed=5):
    """tests/test_parallel.py's _random_scene, as numpy arrays."""
    rng = np.random.default_rng(seed)
    quats = rng.standard_normal((n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    return {"means": rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32),
            "sh": (rng.standard_normal((n, 3, 1)) * 0.5).astype(np.float32),
            "opacities": rng.uniform(-1, 2.5, (n,)).astype(np.float32),
            "log_scales": rng.uniform(-3.5, -1.5, (n, 3)).astype(np.float32),
            "quats": quats}


def _inputs():
    """(scene arrays, [2] camera-to-world, [2] projection, [2, H, W, 4]
    targets): the same numpy arrays in every process."""
    proj = tT.perspective(np.pi / 4, CFG.width / CFG.height, 0.1, 1000.0)
    c2w = np.stack([tT.look_at(eye=[1.2 + 0.1 * i, 1.0, 1.4 - 0.2 * i], target=[0.3, 0.3, 0.3],
                               up=[0.0, 1.0, 0.0]) for i in range(2)]).astype(np.float32)
    targets = np.random.default_rng(6).uniform(size=(2, CFG.height, CFG.width, 4))
    return _scene_arrays(), c2w, np.stack([proj, proj]).astype(np.float32), \
        targets.astype(np.float32)


def _port_inputs():
    arrays, c2w, proj, targets = _inputs()
    return (convert.scene_from_numpy(arrays, device="cpu"),
            convert.camera_from_numpy(c2w, proj, device="cpu"), torch.from_numpy(targets))


def _first(cams):
    return Camera(cam_to_world=cams.cam_to_world[0], proj=cams.proj[0])


def _rows(scene, n):
    return dataclasses.replace(scene, **{f: getattr(scene, f)[:n] for f in FIELDS})


def _np_scene(scene):
    return {f: getattr(scene, f).detach().numpy().copy() for f in FIELDS}


def _adam(scene):
    return torch.optim.Adam([getattr(scene, f) for f in FIELDS], lr=1e-2)


def _degree3_arrays():
    """The scene with tests/test_parallel.py's degree-3 colours (K = 16
    coefficients, seed 6), its first N - 1 = 47 splats: every rank's rows of
    the sharded prepare, sh's included, are cut out, and the last padded."""
    arrays = _scene_arrays()
    arrays["sh"] = (np.random.default_rng(6).standard_normal((48, 3, 16)) * 0.3).astype(
        np.float32)
    return {f: a[:-1] for f, a in arrays.items()}


# ---------------------------------------------------------------- rank bodies


def _mesh_cases(mesh):
    """Every sharded case on one mesh -> numpy results."""
    scene, cams, targets = _port_inputs()
    cam = _first(cams)
    out = {"render": {}, "render_batch": {}, "grads": {}}
    for layout in LAYOUTS:
        full = PM.shard_targets(targets, CFG, mesh, layout)
        for sp in (True, False):
            key = f"{layout}/shard_prepare={sp}"
            out["render"][key] = PM.render_sharded(scene, cam, CFG, mesh, sp, layout).numpy()
            out["render_batch"][key] = PM.render_batch_sharded(scene, cams, CFG, mesh, sp,
                                                                layout).numpy()
            params = train.leaf_copy(scene)
            loss, grads = PM.sharded_train_step(params, cams, full, CFG, mesh, shard_prepare=sp,
                                                band_layout=layout)
            out["grads"][key] = (float(loss), _np_scene(grads))
    # the targets as a DTensor of this rank's block: the same step
    v, t = mesh.get_local_rank("views"), mesh.get_local_rank("tiles")
    full = PM.shard_targets(targets, CFG, mesh)
    block = PM._target_block(full, CFG, mesh)
    dt = PD.local_target_shards(block.clone(), CFG, mesh)
    params = train.leaf_copy(scene)
    loss, grads = PM.sharded_train_step(params, cams, dt, CFG, mesh)
    out["dtensor"] = {"shape": tuple(dt.shape), "full_shape": tuple(full.shape),
                      "round_trip": bool(torch.equal(dt.to_local(), block)),
                      "coords": (v, t), "loss": float(loss), "grads": _np_scene(grads)}
    # fit_scene on the mesh: chunked against per step with a callback
    seen = []
    fitted, losses = train.fit_scene(scene, cams, targets, CFG, steps=FIT_STEPS, mesh=mesh)
    fitted_cb, losses_cb = train.fit_scene(scene, cams, targets, CFG, steps=FIT_STEPS,
                                           mesh=mesh, callback=lambda s, p, l: seen.append(s))
    out["fit"] = {"chunked": (losses, _np_scene(fitted)), "callback": (losses_cb,
                                                                       _np_scene(fitted_cb)),
                  "seen": seen}
    # ZeRO on N - 1 splats (the padding binds) against the replicated fit
    start = _rows(scene, scene.num_gaussians - 1)
    rep = train.leaf_copy(start)
    rep_losses = PM.make_sharded_fit_steps(CFG, mesh, _adam(rep), ZERO_STEPS)(
        rep, cams, PM.shard_targets(targets, CFG, mesh))
    z_scene, z_opt, z_losses = PM.zero_fit_steps(start, cams, targets, CFG, mesh, _adam,
                                                 ZERO_STEPS)
    z_scene2, _, z_losses2 = PM.zero_fit_steps(z_scene, cams, targets, CFG, mesh, z_opt,
                                               ZERO_MORE)
    out["zero"] = {"replicated": (rep_losses.tolist(), _np_scene(rep)),
                   "zero": (z_losses.tolist(), _np_scene(z_scene)),
                   "continued": (z_losses2.tolist(), _np_scene(z_scene2)),
                   "chunk_rows": z_opt.param_groups[0]["params"][0].shape[0]}
    return out


def _sh_allreduce_cases(mesh):
    """The in-backward SH all-reduce (_psum_in_bwd) on one mesh -> numpy
    results and host times (the times differ between ranks)."""
    _, cams, targets = _port_inputs()
    scene = convert.scene_from_numpy(_degree3_arrays(), device="cpu")
    full = PM.shard_targets(targets, CFG, mesh)
    # the marker alone, untraced: identity forward, the gradient summed over
    # the world once, a weight of 1 + tile rank so that the sum shows
    w = 1.0 + mesh.get_local_rank("tiles")
    x = torch.arange(8.0, requires_grad=True)
    with PM._psum_in_bwd(x) as marker:
        y = torch.sum(x * w)
        y.backward()
    out = {"marker": {"value": float(y), "local_value": float(torch.arange(8.0).sum() * w),
                      "grad": marker.wait().numpy().copy(), "issued": marker.issued,
                      "collectives": marker.collectives,
                      "timed": (marker.t_issue, marker.t_end) != (None, None)}}
    # the step, traced, the projection sharded and replicated: its loss and
    # gradients, and the host times of the SH all-reduce's start and of
    # every accumulation into means.grad and quats.grad (which only the
    # projection's backward completes)
    out["step"] = {}
    for sp in (True, False):
        params = train.leaf_copy(scene)
        done = {"means": [], "quats": []}
        hooks = [getattr(params, f).register_post_accumulate_grad_hook(
            lambda p, t=t: t.append(time.perf_counter())) for f, t in done.items()]
        with PM.sh_allreduce_trace() as trace:
            loss, grads = PM.sharded_train_step(params, cams, full, CFG, mesh, shard_prepare=sp)
        for hook in hooks:
            hook.remove()
        out["step"][f"shard_prepare={sp}"] = {
            "loss": float(loss), "grads": _np_scene(grads),
            "markers": [(m.issued, m.collectives) for m in trace],
            "sh_issue": trace[-1].t_issue, "backward_end": trace[-1].t_end,
            "accumulated": done}
    params = train.leaf_copy(scene)
    with PM.sh_allreduce_trace() as trace:
        fit_losses = PM.make_sharded_fit_steps(CFG, mesh, _adam(params), 2)(params, cams, full)
    out["fit"] = {"losses": fit_losses.tolist(),
                  "markers": [(m.issued, m.collectives) for m in trace]}
    return out


def _rank_world4(rank, store, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=4)
    res = {name: _mesh_cases(PM.make_render_mesh(t, v, device_type="cpu"))
           for name, (v, t) in MESHES.items()}
    res["sh_allreduce"] = {name: _sh_allreduce_cases(PM.make_render_mesh(t, v, device_type="cpu"))
                           for name, (v, t) in MESHES.items()}
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def _rank_world2(rank, port, out_dir):
    """The torchrun path: environment variables, initialize_distributed,
    make_pod_mesh; a (1, 2) and a (2, 1) mesh."""
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE="2", LOCAL_RANK=str(rank))
    up = PD.initialize_distributed(device="cpu")
    again = PD.initialize_distributed(device="cpu")
    scene, cams, targets = _port_inputs()
    res = {"initialized": (up, again, dist.get_backend())}
    for v in (1, 2):
        mesh = PD.make_pod_mesh(num_view_shards=v, device_type="cpu")
        params = train.leaf_copy(scene)
        loss, grads = PM.sharded_train_step(params, cams, PM.shard_targets(targets, CFG, mesh),
                                            CFG, mesh)
        zs, zl = train.fit_scene(scene, cams, targets, CFG, steps=2, mesh=mesh, param_shard=True)
        rs, rl = train.fit_scene(scene, cams, targets, CFG, steps=2, mesh=mesh)
        res[f"{v}x{2 // v}"] = {
            "shape": tuple(mesh.shape), "render": PM.render_sharded(scene, _first(cams), CFG,
                                                                    mesh).numpy(),
            "grads": (float(loss), _np_scene(grads)), "zero_fit": (zl, _np_scene(zs)),
            "replicated_fit": (rl, _np_scene(rs))}
    # the same fit on one device
    s1, l1 = train.fit_scene(scene, cams, targets, CFG, steps=2)
    res["single_fit"] = (l1, _np_scene(s1))
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


class _World:
    """Spawned ranks whose results are read once, joined within a timeout."""

    def __init__(self, fn, nprocs, arg, out_dir):
        self.out_dir, self.nprocs = out_dir, nprocs
        self.start = time.monotonic()
        self.ctx = tmp.start_processes(fn, args=(arg, out_dir), nprocs=nprocs, join=False,
                                       start_method="spawn")
        self._results = None

    def results(self):
        if self._results is None:
            deadline = self.start + WORLD_TIMEOUT_S
            try:
                while not self.ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                    if time.monotonic() > deadline:
                        raise AssertionError(f"a rank did not finish in {WORLD_TIMEOUT_S} s")
            finally:
                self.kill()
            self._results = []
            for r in range(self.nprocs):
                with open(os.path.join(self.out_dir, f"rank{r}.pkl"), "rb") as f:
                    self._results.append(pickle.load(f))
        return self._results

    def kill(self):
        for p in self.ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
        assert not any(p.is_alive() for p in self.ctx.processes)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The two spawned worlds, started now and read when a test asks."""
    d4, d2 = tmp_path_factory.mktemp("world4"), tmp_path_factory.mktemp("world2")
    w = {"4": _World(_rank_world4, 4, str(d4 / "store"), str(d4)),
         "2": _World(_rank_world2, 2, _free_port(), str(d2))}
    yield w
    for world in w.values():
        world.kill()


# ------------------------------------------------------------ JAX references


@pytest.fixture(scope="module")
def jref():
    """Every JAX reference of this file:
    - "plain": render of view 0, render_batch, jax.value_and_grad of the L2
      loss of render_batch (also on the degree-3 scene of N - 1 splats),
      instance_demand and band_instance_demands (D = 2, 4 and 8, both
      layouts) — one program;
    - "sharded": render_sharded of view 0 on a 2- and a 4-tile mesh, both
      layouts — one program per mesh (a program holds one mesh);
    - "fit": train.fit_scene without a mesh, optax.adam(1e-2), on the first
      N - 1 splats, ZERO_STEPS + ZERO_MORE steps;
    - "calibrated": calibrate_config_sharded (D = 2, 4, both layouts);
    - the JAX layout functions, for the in-process tests."""
    import jax
    import jax.numpy as jnp
    import optax

    from splatapult_tpu import train as jtrain
    from splatapult_tpu.io.gaussians import GaussianScene as JScene
    from splatapult_tpu.ops import binning as jb
    from splatapult_tpu.ops.tiled import _grid_from_config as jgrid
    from splatapult_tpu.parallel import mesh as jmesh
    from splatapult_tpu.render import Camera as JCamera
    from splatapult_tpu.render import RenderConfig as JRenderConfig
    from splatapult_tpu.render import prepare_splats as jprepare
    from splatapult_tpu.render import render as jrender
    from splatapult_tpu.render import render_batch as jrender_batch

    jcfg = JRenderConfig(**dataclasses.asdict(CFG))
    H = float(CFG.height)
    arrays, c2w, proj, targets = _inputs()
    scene = JScene(**{f: jnp.asarray(a) for f, a in arrays.items()})
    cams = JCamera(cam_to_world=jnp.asarray(c2w), proj=jnp.asarray(proj))
    cam0 = JCamera(cam_to_world=cams.cam_to_world[0], proj=cams.proj[0])
    tg = jnp.asarray(targets)
    scene3 = JScene(**{f: jnp.asarray(a) for f, a in _degree3_arrays().items()})

    @functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
    def plain(scene, scene3, cams, cam0, tg):
        sp = jprepare(scene, cam0, jcfg, sort=False)
        value_and_grad = jax.value_and_grad(
            lambda s: jnp.mean((jrender_batch(s, cams, jcfg) - tg) ** 2))
        loss, grads = value_and_grad(scene)
        loss3, grads3 = value_and_grad(scene3)
        return {"render": jrender(scene, cam0, jcfg), "render_batch": jrender_batch(
                    scene, cams, jcfg), "loss": loss, "grads": grads,
                "degree3_loss": loss3, "degree3_grads": grads3,
                # the full grid's demand at each padded height, y lifted as
                # the interleaved bands lift it
                "demand": {d: jb.instance_demand(
                    sp["mean2d"] + jnp.asarray([0.0, jmesh._padded_height(jcfg, d) - H]),
                    sp["extent"], jgrid(dataclasses.replace(
                        jcfg, height=jmesh._padded_height(jcfg, d)), scene.means.shape[0]))
                    for d in (2, 4, 8)},
                "band_demands": {f"{layout}/{d}": jmesh.band_instance_demands(
                    scene, cam0, jcfg, d, layout) for layout in LAYOUTS for d in (2, 4, 8)}}

    meshes = {d: jmesh.make_render_mesh(num_tile_shards=d) for d in (2, 4)}

    def sharded_program(d):
        @functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
        def sharded(scene, cam0):
            return {layout: jmesh.render_sharded(scene, cam0, jcfg, meshes[d],
                                                 band_layout=layout) for layout in LAYOUTS}
        return sharded

    start = jax.tree.map(lambda a: a[:-1], scene)

    def fit():
        return jtrain.fit_scene(start, cams, tg, jcfg, steps=ZERO_STEPS + ZERO_MORE,
                                optimizer=optax.adam(1e-2))[1]

    def calibrated():
        return {f"{layout}/{d}": jmesh.calibrate_config_sharded(
            scene, cams, jcfg, meshes[d], band_layout=layout).max_instance_mult
            for layout in LAYOUTS for d in (2, 4)}

    # tracing holds the GIL, XLA's compiling does not: each program compiles
    # in a thread while the next one is traced
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        plain_exe = pool.submit(plain.lower(scene, scene3, cams, cam0, tg).compile)
        sharded_exe = {d: pool.submit(sharded_program(d).lower(scene, cam0).compile)
                       for d in (2, 4)}
        fit_losses = pool.submit(fit)
        out = {"plain": jax.tree.map(np.asarray,
                                     plain_exe.result()(scene, scene3, cams, cam0, tg)),
               "sharded": {d: jax.tree.map(np.asarray, exe.result()(scene, cam0))
                           for d, exe in sharded_exe.items()},
               "calibrated": calibrated(), "fit": np.asarray(fit_losses.result())}
    return {**out, "mesh": jmesh, "jcfg": jcfg, "meshes": meshes, "scene": scene}


# -------------------------------------------------- the spawned worlds' cases


def _same_on_every_rank(results):
    def check(a, b, path):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                check(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                check(x, y, f"{path}[{i}]")
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=path)
        else:
            assert a == b, path

    for r, res in enumerate(results[1:], 1):
        check(res, results[0], f"rank {r}")


def _grads_close(got, want, what):
    for f in FIELDS:
        w = np.asarray(getattr(want, f)) if not isinstance(want, dict) else want[f]
        scale = np.abs(w).max()
        assert scale > 0.0 and np.isfinite(got[f]).all(), (what, f)
        err = np.abs(got[f] - w).max() / scale
        assert err <= 2e-4, (what, f, err)


def test_worlds_ran_and_agree_across_ranks(worlds, jref):
    """Every rank of both worlds finished within the timeout, and every rank
    returned the same results (all but the rank's own mesh coordinates)."""
    w4 = worlds["4"].results()
    for name, (v, t) in MESHES.items():
        coords = [r[name]["dtensor"]["coords"] for r in w4]
        assert coords == [(i // t, i % t) for i in range(v * t)], name  # rank = v * T + t
    _same_on_every_rank([{name: {**r[name], "dtensor": {
        k: x for k, x in r[name]["dtensor"].items() if k != "coords"}} for name in MESHES}
        for r in w4])
    w2 = worlds["2"].results()
    _same_on_every_rank(w2)
    assert w2[0]["initialized"] == (True, True, "gloo")
    assert w2[0]["1x2"]["shape"] == (1, 2) and w2[0]["2x1"]["shape"] == (2, 1)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_render_sharded_matches_jax_render(worlds, jref, mesh):
    want = jref["plain"]["render"]
    assert want[..., 3].max() > 0.5
    for key, got in worlds["4"].results()[0][mesh]["render"].items():
        assert got.shape == want.shape == (CFG.height, CFG.width, 4), key
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5, err_msg=key)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_render_batch_sharded_matches_jax_render_batch(worlds, jref, mesh):
    want = jref["plain"]["render_batch"]
    for key, got in worlds["4"].results()[0][mesh]["render_batch"].items():
        assert got.shape == want.shape == (2, CFG.height, CFG.width, 4), key
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5, err_msg=key)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_train_step_matches_jax_value_and_grad(worlds, jref, mesh):
    """Both layouts, the projection sharded and replicated: the sharded
    prepare's gather must sum its cotangents in the backward (a slice of the
    local one drops the other ranks' part: the forward would still be equal,
    the gradients not)."""
    want_loss, want = float(jref["plain"]["loss"]), jref["plain"]["grads"]
    res = worlds["4"].results()[0][mesh]
    for key, (loss, grads) in {**res["grads"], "dtensor targets": (
            res["dtensor"]["loss"], res["dtensor"]["grads"])}.items():
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5, err_msg=key)
        _grads_close(grads, want, f"{mesh} {key}")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_local_target_shards_round_trip(worlds, mesh):
    d = worlds["4"].results()[0][mesh]["dtensor"]
    assert d["round_trip"] and d["shape"] == d["full_shape"] == (2, 64, CFG.width, 4)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_fit_scene_on_a_mesh_chunked_matches_callback(worlds, mesh):
    f = worlds["4"].results()[0][mesh]["fit"]
    (losses, scene), (losses_cb, scene_cb) = f["chunked"], f["callback"]
    assert f["seen"] == list(range(FIT_STEPS))
    np.testing.assert_allclose(losses, losses_cb, rtol=2e-5)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    for k in FIELDS:
        np.testing.assert_allclose(scene[k], scene_cb[k], rtol=1e-4, atol=2e-6, err_msg=k)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_zero_fit_matches_replicated_and_jax(worlds, jref, mesh):
    """ZeRO on N - 1 = 47 splats (padded to 48 over 4 ranks) against the
    replicated sharded fit with the same Adam, then continued with the
    optimizer it returned; its five losses against the JAX fit_scene."""
    z = worlds["4"].results()[0][mesh]["zero"]
    (rep_l, rep_s), (z_l, z_s), (c_l, c_s) = z["replicated"], z["zero"], z["continued"]
    assert z["chunk_rows"] == 12 and z_s["means"].shape == (47, 3) == c_s["means"].shape
    np.testing.assert_allclose(z_l, rep_l, rtol=2e-5)
    for k in FIELDS:
        np.testing.assert_allclose(z_s[k], rep_s[k], rtol=1e-4, atol=2e-6, err_msg=k)
    assert c_l[-1] < c_l[0] < z_l[-1]
    np.testing.assert_allclose(z_l + c_l, jref["fit"], rtol=1e-4)


def test_two_rank_world_from_torchrun_environment(worlds, jref):
    """initialize_distributed from MASTER_ADDR/PORT, RANK, WORLD_SIZE and
    LOCAL_RANK (True, then True again), make_pod_mesh with 1 and 2 view
    shards: render_sharded and the step's gradients against the JAX
    package; fit_scene(param_shard=True) against fit_scene on the same mesh
    (the JAX tolerances) and its losses against the port's fit on one
    device."""
    res = worlds["2"].results()[0]
    l1, _ = res["single_fit"]
    for m in ("1x2", "2x1"):
        np.testing.assert_allclose(res[m]["render"], jref["plain"]["render"], rtol=0, atol=2e-5)
        loss, grads = res[m]["grads"]
        np.testing.assert_allclose(loss, float(jref["plain"]["loss"]), rtol=1e-5)
        _grads_close(grads, jref["plain"]["grads"], m)
        (zl, zs), (rl, rs) = res[m]["zero_fit"], res[m]["replicated_fit"]
        np.testing.assert_allclose(zl, rl, rtol=2e-5, err_msg=m)
        np.testing.assert_allclose(zl, l1, rtol=2e-5, err_msg=m)
        for k in FIELDS:
            np.testing.assert_allclose(zs[k], rs[k], rtol=1e-4, atol=2e-6, err_msg=f"{m} {k}")


# sum over the ranks of the marker test's weight, 1 + tile rank
SH_ALLREDUCE_SUM = {"2x2": 2 * (1 + 2), "1x4": 1 + 2 + 3 + 4}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_psum_in_bwd_marker_semantics(worlds, mesh):
    """The counterpart of tests/test_parallel.py's: identity forward (each
    rank's value is its own), and the gradient summed over the world exactly
    once, with weights 1 + tile rank so that the sum shows; outside
    sh_allreduce_trace the marker times nothing."""
    for res in worlds["4"].results():
        m = res["sh_allreduce"][mesh]["marker"]
        assert m["value"] == m["local_value"]
        np.testing.assert_array_equal(m["grad"], np.full(8, float(SH_ALLREDUCE_SUM[mesh])))
        assert (m["issued"], m["collectives"], m["timed"]) == (1, 1, False)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_train_step_degree3_matches_jax_value_and_grad(worlds, jref, mesh):
    """The in-backward SH all-reduce on a degree-3 scene (K = 16) of N - 1
    splats, the projection sharded (every rank's sh rows cut out where they
    are read, the last rank's padded) and replicated, against
    jax.value_and_grad of the unsharded loss: loss rtol 1e-5, each field
    within 2e-4 of its largest; every rank the same."""
    want_loss, want = float(jref["plain"]["degree3_loss"]), jref["plain"]["degree3_grads"]
    assert np.asarray(want.sh).shape == (47, 3, 16)
    steps = [{k: {f: s[f] for f in ("loss", "grads")} for k, s in
              r["sh_allreduce"][mesh]["step"].items()} for r in worlds["4"].results()]
    _same_on_every_rank(steps)
    for key, s in steps[0].items():
        np.testing.assert_allclose(s["loss"], want_loss, rtol=1e-5, err_msg=key)
        _grads_close(s["grads"], want, f"{mesh} {key}")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sh_allreduce_issued_in_last_backward_before_means(worlds, mesh):
    """The step's schedule on every rank, the projection sharded and
    replicated: one SH all-reduce a step, started inside the LAST view's
    backward (after the earlier view's accumulations) and before that
    backward accumulates means.grad (which the SH evaluation's view
    directions also feed) and quats.grad (which only the projection's
    backward completes): the projection's backward is left to hide it. Each
    step of make_sharded_fit_steps issues one too."""
    per = 2 // MESHES[mesh][0]  # views a rank
    for r, res in enumerate(worlds["4"].results()):
        for key, s in res["sh_allreduce"][mesh]["step"].items():
            what = f"rank {r} {key}"
            assert s["markers"] == [(1, 1)], what
            for field, times in s["accumulated"].items():
                assert len(times) == per, (what, field)
                assert s["sh_issue"] < times[-1] <= s["backward_end"], (what, field)
                if per > 1:
                    assert times[-2] < s["sh_issue"], (what, field)
        fit = res["sh_allreduce"][mesh]["fit"]
        assert fit["markers"] == [(1, 1)] * 2 and np.all(np.isfinite(fit["losses"])), r


# ----------------------------------------------- in this process, no group


@pytest.mark.parametrize("d", [2, 4])
def test_layout_functions_match_jax(jref, d):
    """_padded_height, _shard_config, shard_targets (both layouts) and
    _deinterleave_rows, bit for bit; the height (48, and 80) divides by
    neither shard count's band."""
    jm, jcfg = jref["mesh"], jref["jcfg"]
    rng = np.random.default_rng(d)
    for h in (48, 80):
        cfg, jc = (dataclasses.replace(c, height=h) for c in (CFG, jcfg))
        assert PM._padded_height(cfg, d) == jm._padded_height(jc, d) > h
        assert dataclasses.asdict(PM._shard_config(cfg, d)) == dataclasses.asdict(
            jm._shard_config(jc, d))
        tg = rng.uniform(size=(3, h, cfg.width, 4)).astype(np.float32)
        for layout in LAYOUTS:
            got = PM.shard_targets(torch.from_numpy(tg), cfg, {"views": 1, "tiles": d}, layout)
            want = jm.shard_targets(tg, jc, jref["meshes"][d], layout)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=layout)
        stacked = rng.uniform(size=(2, PM._padded_height(cfg, d), cfg.width, 4)).astype(
            np.float32)
        np.testing.assert_array_equal(
            PM._deinterleave_rows(torch.from_numpy(stacked), cfg, d).numpy(),
            np.asarray(jm._deinterleave_rows(stacked, jc, d)))


@pytest.mark.parametrize("vt", [(1, 2), (1, 4), (2, 2), (4, 2)])
def test_pad_scene_to_mesh_matches_jax(jref, vt):
    """The inert padding rows, bit for bit (47 splats: 1 to 9 rows)."""
    import jax

    jm = jref["mesh"]
    v, t = vt
    jscene = jax.tree.map(lambda a: a[:47], jref["scene"])
    want, wn = jm.pad_scene_to_mesh(jscene, jm.make_render_mesh(t, v))
    got, n = PM.pad_scene_to_mesh(convert.scene_from_numpy(jscene, device="cpu"),
                                  {"views": v, "tiles": t})
    assert n == wn == 47 and got.num_gaussians % (v * t) == 0 and got.num_gaussians > 47
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("d", [2, 4, 8])
def test_band_instance_demands_match_jax(jref, layout, d):
    scene, cams, _ = _port_inputs()
    got = PM.band_instance_demands(scene, _first(cams), CFG, d, layout)
    want = jref["plain"]["band_demands"][f"{layout}/{d}"]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if layout == "interleaved":  # every instance of the padded grid in exactly one band
        assert int(got.sum()) == int(jref["plain"]["demand"][d]) > 0


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("d", [2, 4])
def test_calibrate_config_sharded_matches_jax(jref, layout, d):
    scene, cams, _ = _port_inputs()
    cal = PM.calibrate_config_sharded(scene, cams, CFG, {"views": 1, "tiles": d},
                                      band_layout=layout)
    assert cal.max_instance_mult == jref["calibrated"][f"{layout}/{d}"]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("d", [2, 4])
def test_band_images_match_jax_render_sharded(jref, layout, d):
    """Each rank's band from the band function, run in turn in this process,
    stacked, deinterleaved and cropped: the JAX render_sharded on a d-tile
    mesh. Rows past the height are padding. The interleaved bands keep the
    image's tile rows and pixel coordinates, so they are the port's render
    bit for bit; the JAX package lifts mean2d by the padding instead, which
    rounds it."""
    scene, cams, _ = _port_inputs()
    splats = prepare_splats(scene, _first(cams), CFG, sort=False)
    bands = torch.cat([PM._band_fn(layout)(splats, r, d, CFG) for r in range(d)])
    assert bands.shape == (PM._padded_height(CFG, d), CFG.width, 4)
    if layout == "interleaved":
        bands = PM._deinterleave_rows(bands, CFG, d)
    want = jref["sharded"][d][layout]
    np.testing.assert_allclose(bands[: CFG.height].numpy(), want, rtol=0, atol=2e-5)
    whole = render(scene, _first(cams), CFG)
    np.testing.assert_allclose(want, whole.numpy(), rtol=0, atol=2e-5)
    if layout == "interleaved":  # the image's own tile rows: the port's render, bit for bit
        assert torch.equal(bands[: CFG.height], whole)


# ------------------------------------------------------------------- raises


def _entry_points():
    mesh = {"views": 1, "tiles": 2}
    scene, cams, targets = _port_inputs()
    return {
        "render_sharded": lambda c: PM.render_sharded(scene, _first(cams), c, mesh),
        "render_batch_sharded": lambda c: PM.render_batch_sharded(scene, cams, c, mesh),
        "calibrate_config_sharded": lambda c: PM.calibrate_config_sharded(scene, cams, c, mesh),
        "sharded_train_step": lambda c: PM.sharded_train_step(
            train.leaf_copy(scene), cams, targets, c, mesh),
        "make_sharded_train_step": lambda c: PM.make_sharded_train_step(c, mesh)(
            train.leaf_copy(scene), cams, targets),
        "make_sharded_fit_steps": lambda c: PM.make_sharded_fit_steps(
            c, mesh, None, 1)(train.leaf_copy(scene), cams, targets),
        "zero_fit_steps": lambda c: PM.zero_fit_steps(scene, cams, targets, c, mesh, _adam, 1),
        "fit_scene": lambda c: train.fit_scene(scene, cams, targets, c, steps=1, mesh=mesh),
        "fit_scene_param_shard": lambda c: train.fit_scene(scene, cams, targets, c, steps=1,
                                                           mesh=mesh, param_shard=True),
    }


@pytest.mark.parametrize("fn", list(_entry_points()))
def test_supersample_raises(fn):
    """The JAX functions build the bands at the output size and ignore
    supersample (ROADMAP queue 3); the port refuses the config."""
    with pytest.raises(ValueError, match="supersample"):
        _entry_points()[fn](dataclasses.replace(CFG, supersample=2))


def test_param_shard_with_a_callback_raises():
    scene, cams, targets = _port_inputs()
    with pytest.raises(ValueError, match="callback"):
        train.fit_scene(scene, cams, targets, CFG, steps=1, mesh={"views": 1, "tiles": 2},
                        param_shard=True, callback=lambda *a: None)
    with pytest.raises(ValueError, match="mesh"):
        train.fit_scene(scene, cams, targets, CFG, steps=1, param_shard=True)


@pytest.mark.parametrize("kw", [{"grad_allreduce": "ring"}, {"sh_psum_chunks": 2}])
def test_xla_scheduler_workarounds_raise(kw):
    scene, cams, targets = _port_inputs()
    mesh = {"views": 1, "tiles": 2}
    with pytest.raises(NotImplementedError, match="item 16"):
        PM.sharded_train_step(train.leaf_copy(scene), cams, targets, CFG, mesh, **kw)
    with pytest.raises(NotImplementedError, match="item 16"):
        PM.make_sharded_fit_steps(CFG, mesh, None, 1, **kw)
    with pytest.raises(NotImplementedError, match="item 16"):
        PM.make_sharded_train_step(CFG, mesh, None, **kw)


def test_sh_psum_chunks_below_one_raises():
    scene, cams, targets = _port_inputs()
    mesh = {"views": 1, "tiles": 2}
    with pytest.raises(ValueError, match="sh_psum_chunks"):
        PM.sharded_train_step(train.leaf_copy(scene), cams, targets, CFG, mesh, sh_psum_chunks=0)
    with pytest.raises(ValueError, match="sh_psum_chunks"):
        PM.make_sharded_fit_steps(CFG, mesh, None, 1, sh_psum_chunks=0)


@pytest.mark.parametrize("fn", ["make_render_mesh", "initialize_distributed"])
def test_cuda_asked_for_without_a_card_raises(fn):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the request is valid")
    call = {"make_render_mesh": PM.make_render_mesh,
            "initialize_distributed": PD.initialize_distributed}[fn]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
