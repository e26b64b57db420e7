"""PyTorch port vs. the JAX package: camera-path rendering with shared tile
binning across view clusters (splatapult_tpu_torch/cluster.py against
splatapult_tpu/cluster.py), on the CPU.

The JAX package's small config (64x64, tile 16, block 8; tests/test_cluster.py)
with 48-96 random splats made from numpy seeds, and camera matrices made in
numpy, handed to both packages (convert.py). The JAX references come from
two compiled programs in a module fixture, with XLA's backend optimisations
off (JAX_FAST_COMPILE): the cluster cases share their shapes (96 splats,
3 views) and run as one body under lax.map; the gradients. Each compiles in
a thread while the next one is traced. (The production profile and
packed_feats16 under shared bins are test_torch_stereo.py's.)

Tolerances, and why:
- the union rects and every array of the bins: bit for bit on the same
  inputs (the JAX package's per-view mean2d / extent and view 0's depth),
  also where splats lie behind view 0 (negative depth, which the key clamps
  to 0) and are live in another view. Demands and the calibrated
  max_instance_mult end to end: equal.
- images: atol 3e-5 under the exact profile (test_torch_render.py).
- the port against itself: the reference view equals render() of it within
  2e-5 and the other views of a path cluster stay within the JAX package's
  own bounds of per-view rendering (tests/test_cluster.py: max < 0.06, mean
  < 2e-3); render_path_clustered with a gate that refuses, and with
  cluster_size=1, equals render_batch bit for bit (the same renders).
- gradients of mean(render_cluster ** 2): each field within 2e-4 of that
  field's largest gradient, the loss rtol 1e-5; a splat culled in a view
  gets exactly zero gradient from that view.
- scene_depth_scale and cluster_shareable: the JAX package's values and
  decisions exactly (the same numpy operations on the same arrays).
"""

import concurrent.futures
import dataclasses
import functools
import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from splatapult_tpu import cluster as jcluster
from splatapult_tpu.io.gaussians import GaussianScene as JGaussianScene
from splatapult_tpu.ops import binning as jb
from splatapult_tpu.ops.tiled import _grid_from_config as jgrid_from_config
from splatapult_tpu.render import CAPACITY_BUCKET as JCAPACITY_BUCKET
from splatapult_tpu.render import Camera as JCamera
from splatapult_tpu.render import RenderConfig as JRenderConfig
from splatapult_tpu.render import capacity_mult_for_demand as jcapacity_mult_for_demand

from splatapult_tpu_torch import cluster, convert
from splatapult_tpu_torch.core import transforms as tT
from splatapult_tpu_torch.ops import binning as tb
from splatapult_tpu_torch.ops.tiled import _grid_from_config

# One thread for torch: the suite runs several worker processes per machine,
# and an oversubscribed intra-op thread pool slows every worker down.
torch.set_num_threads(1)

R = importlib.import_module("splatapult_tpu_torch.render")  # the package re-exports render()
JAX_FAST_COMPILE = {"xla_backend_optimization_level": 0}
FIELDS = ("means", "sh", "opacities", "log_scales", "quats")
BINS_COMPARED = ("inst_splat", "block_meta", "seg_offs", "seg_cnt", "block_tile",
                 "block_first", "block_live", "tile_ok", "tile_count", "num_culled_instances")
CFG = JRenderConfig(width=64, height=64, pipeline="tiled", tile_size=16, tile_block=8,
                    max_instance_mult=60)
PROJ = tT.perspective(np.pi / 4, 1.0, 0.1, 1000.0)


def _c2w(eye, target=(0.3, 0.3, 0.3)):
    return tT.look_at(eye=list(eye), target=list(target), up=[0.0, 1.0, 0.0])


def _cameras(mats):
    """[K] camera-to-world matrices -> (c2w [K, 4, 4], proj [K, 4, 4]) numpy."""
    mats = np.stack(mats).astype(np.float32)
    return mats, np.broadcast_to(PROJ, mats.shape).copy()


def _inplane(k, step):
    """K views differing by in-plane (right / up) translation: view depth is
    invariant, so shared binning is order-exact (tests/test_cluster.py)."""
    base = _c2w((1.2, 1.1, 1.3))
    mats = []
    for i in range(k):
        m = base.copy()
        m[:3, 3] += (i - k // 2) * step * base[:3, 0] + (i % 2) * 0.5 * step * base[:3, 1]
        mats.append(m)
    return _cameras(mats)


def _path(k, dt):
    """K consecutive views of a circular path: translation along the view
    axis and rotation, approximate under sharing (tests/test_cluster.py)."""
    return _cameras([_c2w((1.6 * np.cos(0.3 + i * dt), 1.0, 1.6 * np.sin(0.3 + i * dt)),
                          (0.0, 0.2, 0.0)) for i in range(k)])


def _behind():
    """View 0 stands inside the scene looking along -z; views 1 and 2 stand
    behind it: the splats between them lie behind view 0 (negative depth in
    the shared key) and are live in views 1 and 2."""
    return _cameras([_c2w((0.0, 0.1, 0.3), (0.0, 0.1, -1.0)),
                     _c2w((0.0, 0.1, 1.6), (0.0, 0.1, -1.0)),
                     _c2w((0.1, 0.15, 1.9), (0.0, 0.1, -1.0))])


def _scene_arrays(seed, n, spread):
    rng = np.random.default_rng(seed)
    quats = rng.standard_normal((n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    return {"means": rng.uniform(-spread, spread, (n, 3)).astype(np.float32),
            "sh": (rng.standard_normal((n, 3, 1)) * 0.5).astype(np.float32),
            "opacities": rng.uniform(-1.0, 2.5, (n,)).astype(np.float32),
            "log_scales": rng.uniform(-3.5, -1.5, (n, 3)).astype(np.float32),
            "quats": quats}


PATH6 = _path(6, 0.04)
# name -> (scene seed, spread, cameras): 96 splats and 3 views each
CASES = {
    "inplane": (10, 0.8, _inplane(3, 0.15)),
    "culling": (11, 1.2, _inplane(3, 0.5)),  # close in: splats cull in some views only
    "path": (1234, 0.8, _path(3, 0.04)),
    "behind": (12, 0.8, _behind()),
    # the two clusters of render_path_clustered(cluster_size=3) on PATH6
    "path6_0": (13, 0.8, (PATH6[0][:3], PATH6[1][:3])),
    "path6_1": (13, 0.8, (PATH6[0][3:], PATH6[1][3:])),
}
GRAD_CASE = (14, 48, _inplane(2, 0.1))


def _port(arrays, cams, jcfg=CFG):
    return (convert.scene_from_numpy(arrays, device="cpu"),
            convert.camera_from_numpy(*cams, device="cpu"), convert.config_from_jax(jcfg))


def _jscene(arrays):
    return JGaussianScene(**{f: jnp.asarray(a) for f, a in arrays.items()})


@pytest.fixture(scope="module")
def ref():
    """Every JAX reference of this file: per case of CASES, the per-view
    prepared dicts, the union rects, the bins of the union, the union demand
    and render_cluster (one body under lax.map); jax.value_and_grad of
    mean(render_cluster ** 2) for GRAD_CASE."""
    arrays = {k: _scene_arrays(seed, 96, spread) for k, (seed, spread, _) in CASES.items()}
    cases = (jax.tree.map(lambda *a: jnp.stack(a), *[_jscene(a) for a in arrays.values()]),
             jnp.stack([c[0] for _, _, c in CASES.values()]),
             jnp.stack([c[1] for _, _, c in CASES.values()]))
    grad_arrays = _scene_arrays(GRAD_CASE[0], GRAD_CASE[1], 0.8)
    grad_cams = JCamera(*map(jnp.asarray, GRAD_CASE[2]))

    def case(x):
        s, c2w, proj = x
        cams = JCamera(cam_to_world=c2w, proj=proj)
        ds, um, ue = jcluster.prepare_cluster(s, cams, CFG)
        return {"ds": [{k: d[k] for k in ("mean2d", "extent", "depth", "mask")} for d in ds],
                "union": (um, ue),
                "bins": jb.bin_splats(um, ue, jgrid_from_config(CFG, um.shape[0]),
                                      depth=ds[0]["depth"]),
                "demand": jcluster.cluster_instance_demand(s, cams, CFG),
                "image": jcluster.render_cluster(s, cams, CFG)}

    @functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
    def forward(cases):
        return jax.lax.map(case, cases)

    @functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
    def grads(scene):
        return jax.value_and_grad(
            lambda s: jnp.mean(jcluster.render_cluster(s, grad_cams, CFG) ** 2))(scene)

    # tracing holds the GIL, XLA's compiling does not: each program compiles
    # in a thread while the next one is traced
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        forward_exe = pool.submit(forward.lower(cases).compile)
        grads_exe = pool.submit(grads.lower(_jscene(grad_arrays)).compile)
        by_case = jax.tree.map(np.asarray, forward_exe.result()(cases))
        loss, g = grads_exe.result()(_jscene(grad_arrays))
    out = {k: {**jax.tree.map(lambda a: a[i], by_case), "arrays": arrays[k],
               "cams": CASES[k][2]} for i, k in enumerate(CASES)}
    out["grads"] = (grad_arrays, GRAD_CASE[2], float(loss),
                    {f: np.asarray(getattr(g, f)) for f in FIELDS})
    return out


@pytest.mark.parametrize("case", ["inplane", "culling", "path", "behind"])
def test_union_rects_and_bins_bit_for_bit(ref, case):
    r = ref[case]
    ds = [{k: torch.from_numpy(np.array(d[k])) for k in ("mean2d", "extent")} for d in r["ds"]]
    um, ue = cluster.union_rects(ds)
    np.testing.assert_array_equal(um.numpy().view(np.int32), r["union"][0].view(np.int32))
    np.testing.assert_array_equal(ue.numpy().view(np.int32), r["union"][1].view(np.int32))
    grid = _grid_from_config(convert.config_from_jax(CFG), um.shape[0])
    bins = tb.bin_splats(um, ue, grid, depth=torch.from_numpy(np.array(r["ds"][0]["depth"])))
    for k in BINS_COMPARED:
        a, b = bins[k].numpy(), r["bins"][k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert int(bins["num_culled_instances"]) == 0 and int(bins["tile_count"].sum()) > 0
    masks = np.stack([d["mask"] for d in r["ds"]])
    if case in ("culling", "behind"):  # splats culled in some views ride the shared lists
        some = masks.any(0) & ~masks.all(0)
        assert (bins["seg_cnt"].numpy()[some] > 0).sum() > 5
    if case == "behind":  # behind view 0, live in view 1, binned with its clamped depth
        behind = (r["ds"][0]["depth"] <= 0.0) & masks[1]
        assert (bins["seg_cnt"].numpy()[behind] > 0).sum() > 5


@pytest.mark.parametrize("case", ["inplane", "path", "behind"])
def test_demand_matches_jax(ref, case):
    scene, cams, cfg = _port(ref[case]["arrays"], ref[case]["cams"])
    assert int(cluster.cluster_instance_demand(scene, cams, cfg)) == int(ref[case]["demand"])


def test_calibration_matches_jax(ref):
    """calibrate_config_cluster on PATH6 in clusters of 3: the JAX package's
    capacity_mult_for_demand of the peak of the two clusters' demands."""
    arrays = ref["path6_0"]["arrays"]
    scene, cams, cfg = _port(arrays, PATH6)
    small = dataclasses.replace(cfg, max_instance_mult=0.01)
    cal = cluster.calibrate_config_cluster(scene, cams, small, cluster_size=3)
    peak = max(int(ref["path6_0"]["demand"]), int(ref["path6_1"]["demand"]))
    assert cal.max_instance_mult == jcapacity_mult_for_demand(
        peak, 96, dataclasses.replace(CFG, max_instance_mult=0.01), 1.06, JCAPACITY_BUCKET)
    assert cal.max_instance_mult > small.max_instance_mult
    img = cluster.render_cluster(scene, R.Camera(cams.cam_to_world[:3], cams.proj[:3]), cal)
    np.testing.assert_allclose(img.numpy(), ref["path6_0"]["image"], rtol=0, atol=3e-5)


@pytest.mark.parametrize("case", ["inplane", "culling", "path", "behind"])
def test_render_cluster_matches_jax(ref, case):
    want = ref[case]["image"]
    got = cluster.render_cluster(*_port(ref[case]["arrays"], ref[case]["cams"]))
    assert got.shape == want.shape == (3, 64, 64, 4) and want[..., 3].max() > 0.5
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-5)


@pytest.mark.parametrize("case", ["inplane", "culling", "path"])
def test_views_against_per_view_rendering(ref, case):
    """In-plane clusters are order-exact (every view within 2e-5 of render()
    of it, culled-in-some-views splats and all); a path cluster's reference
    view is, and its other views stay within the JAX package's bounds."""
    scene, cams, cfg = _port(ref[case]["arrays"], ref[case]["cams"])
    got = cluster.render_cluster(scene, cams, cfg).numpy()
    want = R.render_batch(scene, cams, cfg).numpy()
    if case == "path":
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=2e-5)
        diff = np.abs(got - want)
        assert diff.max() < 0.06 and diff.mean() < 2e-3, (diff.max(), diff.mean())
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_render_cluster_gradients_match_jax(ref):
    arrays, cams, want_loss, want = ref["grads"]
    scene, cam, cfg = _port(arrays, cams)
    for f in FIELDS:
        getattr(scene, f).requires_grad_(True)
    loss = torch.mean(cluster.render_cluster(scene, cam, cfg) ** 2)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    for f, w in want.items():
        got = getattr(scene, f).grad.numpy()
        scale = np.abs(w).max()
        assert scale > 0.0 and np.isfinite(got).all(), f
        assert np.abs(got - w).max() / scale <= 2e-4, (f, np.abs(got - w).max() / scale)


def test_culled_view_gives_exactly_zero_gradient(ref):
    """The splats behind view 0 and live in view 1 get exactly zero gradient
    from view 0's image, in every field, and a non-zero one from view 1's."""
    r = ref["behind"]
    masks = [d["mask"] for d in r["ds"]]
    only_later = ~masks[0] & masks[1]
    assert only_later.sum() > 5
    grads = []
    for v in (0, 1):
        scene, cams, cfg = _port(r["arrays"], r["cams"])
        for f in FIELDS:
            getattr(scene, f).requires_grad_(True)
        torch.mean(cluster.render_cluster(scene, cams, cfg)[v] ** 2).backward()
        grads.append({f: getattr(scene, f).grad.numpy() for f in FIELDS})
    for f in FIELDS:
        assert (grads[0][f][only_later] == 0.0).all(), f
        assert np.isfinite(grads[0][f]).all() and np.isfinite(grads[1][f]).all(), f
    assert np.abs(grads[1]["opacities"][only_later]).max() > 0.0


def test_scene_depth_scale_matches_jax(ref):
    for k in ("inplane", "culling"):
        arrays = ref[k]["arrays"]
        got = cluster.scene_depth_scale(convert.scene_from_numpy(arrays, device="cpu"))
        assert got == jcluster.scene_depth_scale(JGaussianScene(**arrays)) > 0.0


@pytest.mark.parametrize("path,shift,want", [
    ("tight", 0.2, True), ("far", 0.2, False), ("inplane", 1e-3, True),
    ("path6_auto", None, False), ("inplane_auto", None, True)])
def test_cluster_shareable_matches_jax(ref, path, shift, want):
    """The JAX tests' tight, far and in-plane paths (tests/test_cluster.py),
    and the "auto" threshold (0.5 % of the content radius) on a 0.04 rad path
    and on an in-plane cluster."""
    mats = {"tight": _path(4, 0.01), "far": _path(4, 0.8), "inplane": _inplane(3, 0.5),
            "path6_auto": PATH6, "inplane_auto": _inplane(3, 0.5)}[path]
    r_scale = 1.0
    if shift is None:
        r_scale = jcluster.scene_depth_scale(JGaussianScene(**ref["inplane"]["arrays"]))
        shift = 0.005 * r_scale
    got = cluster.cluster_shareable(convert.camera_from_numpy(*mats, device="cpu"), shift,
                                    r_scale)
    assert got == jcluster.cluster_shareable(JCamera(*mats), shift, r_scale) == want


def test_render_path_clustered(ref):
    """PATH6 in clusters of 3: shared without the gate, the JAX package's
    render_cluster of each cluster; under "auto" (the 0.04 rad steps move
    the depth more than 0.5 % of the content radius) and with a gate that
    refuses, or cluster_size=1, render_batch of the path bit for bit."""
    scene, cams, cfg = _port(ref["path6_0"]["arrays"], PATH6)
    shared = cluster.render_path_clustered(scene, cams, cfg, cluster_size=3,
                                           max_depth_shift=None)
    assert shared.shape == (6, 64, 64, 4)
    want = np.concatenate([ref["path6_0"]["image"], ref["path6_1"]["image"]])
    np.testing.assert_allclose(shared.numpy(), want, rtol=0, atol=3e-5)
    per_view = R.render_batch(scene, cams, cfg)
    for kw in (dict(cluster_size=3), dict(cluster_size=3, max_depth_shift=1e-9),
               dict(cluster_size=1, max_depth_shift=None)):
        assert torch.equal(cluster.render_path_clustered(scene, cams, cfg, **kw), per_view), kw


@pytest.mark.parametrize("fn", ["render_cluster", "calibrate_config_cluster",
                                "render_path_clustered"])
def test_supersample_raises(fn):
    """The JAX package builds the grid at the output size and ignores
    supersample here (ROADMAP queue 3); the port refuses the config."""
    scene, cams, cfg = _port(_scene_arrays(0, 16, 0.8), _inplane(2, 0.1))
    with pytest.raises(ValueError, match="supersample"):
        getattr(cluster, fn)(scene, cams, dataclasses.replace(cfg, supersample=2))
