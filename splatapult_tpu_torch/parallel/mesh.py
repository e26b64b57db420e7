"""Multi-device rendering and training on torch.distributed: tile-row bands,
view sharding and ZeRO parameter sharding over a DeviceMesh.

The port of splatapult_tpu/parallel/mesh.py, one process per device
(torchrun's model). A ``DeviceMesh`` with dims ("views", "tiles") takes the
place of the ``jax.sharding.Mesh``; rank = v * T + t, as the JAX
``reshape(V, T)`` lays the devices out. NCCL carries the collectives on the
card, gloo on the CPU (parallel/comm.py).

- **Tile parallelism:** the image's tile rows are split across the "tiles"
  dim. Each rank runs the whole pipeline (binning, the expand kernel, the
  composite kernels) on its own rows: by default the INTERLEAVED rows
  r % T == t of the full height-padded grid (``row_stride = T``,
  ``row_offset = t``), or a contiguous band. The projection and SH are
  either replicated or sharded over the same dim (``shard_prepare``).
- **View parallelism:** a [V]-batched camera is split across "views".
- **Gradients:** each rank differentiates its own band loss. The SH
  gradient (48 of the 61 gradient floats a splat at degree 3) is summed over
  the world INSIDE the rank's last backward, by an asynchronous all-reduce
  started as soon as it is complete (``_psum_in_bwd``), while the
  projection's backward still runs; one terminal all-reduce of the four
  small gradients and the loss (flattened into one buffer) completes the
  rest. Under ZeRO (``zero_fit_steps``) each rank owns a chunk of the
  splats and its Adam state instead, and the collectives' backward passes
  complete the chunk's gradients: no gradient all-reduce remains.

Every rank computes the same thing from the replicated scene, so the layout
functions and the per-rank band functions (``_composite_band_interleaved``,
``_composite_band``, ``band_instance_demands``) are plain functions of the
rank and the shard count: one process can run every rank's band in turn.

The sharded entry points run the tiled pipeline whatever ``config.pipeline``
says, as the JAX ones do, and raise ValueError for ``supersample > 1``: the
bands are built at the output size, and the JAX functions, which ignore
supersample, would return an output-size image without the box filter
(ROADMAP queue 3).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch
import torch.distributed as dist

from splatapult_tpu_torch._device import DEFAULT_DEVICE, resolve_device
from splatapult_tpu_torch.io.gaussians import GaussianScene
from splatapult_tpu_torch.ops.binning import bin_splats, instance_demand
from splatapult_tpu_torch.ops.composite import composite_from_feats
from splatapult_tpu_torch.ops.tiled import (
    _grid_from_config,
    assemble_image,
    composite_tiled,
    pack_features,
)
from splatapult_tpu_torch.parallel.comm import (
    all_gather,
    all_reduce_,
    all_reduce_async_,
    reduce_scatter,
)
from splatapult_tpu_torch.render import (
    CAPACITY_BUCKET,
    Camera,
    RenderConfig,
    capacity_mult_for_demand,
    prepare_splats,
)
from splatapult_tpu_torch.train import _views

_DIMS = ("views", "tiles")
_FIELDS = ("means", "sh", "opacities", "log_scales", "quats")


def make_render_mesh(num_tile_shards=None, num_view_shards: int = 1, device_type=None):
    """DeviceMesh with ("views", "tiles") dims over the initialized world ->
    rank v * num_tile_shards + t sits at (v, t).

    Every rank calls it alike. ``device_type`` defaults to "cuda" and raises
    RuntimeError without a card unless "cpu" is asked for; the world must
    hold exactly num_view_shards x num_tile_shards ranks."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device_type or DEFAULT_DEVICE)
    if not dist.is_initialized():
        raise RuntimeError("make_render_mesh needs an initialized process group "
                           "(parallel.distributed.initialize_distributed)")
    world = dist.get_world_size()
    if num_tile_shards is None:
        num_tile_shards = world // num_view_shards
    if num_view_shards * num_tile_shards != world:
        raise ValueError(f"a {num_view_shards} x {num_tile_shards} mesh needs "
                         f"{num_view_shards * num_tile_shards} ranks; the world has {world}")
    return DeviceMesh(dev.type, torch.arange(world).reshape(num_view_shards, num_tile_shards),
                      mesh_dim_names=_DIMS)


def _shape(mesh) -> dict:
    """{"views": V, "tiles": T}: the JAX ``Mesh.shape``. ``mesh`` is a
    DeviceMesh, or that dict itself for the functions that need no process
    group (calibrate_config_sharded, shard_targets, pad_scene_to_mesh)."""
    if isinstance(mesh, dict):
        return {"views": mesh.get("views", 1), "tiles": mesh["tiles"]}
    if tuple(getattr(mesh, "mesh_dim_names", None) or ()) != _DIMS:
        raise ValueError(f"mesh must be a DeviceMesh with dims {_DIMS} (make_render_mesh)")
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _coords(mesh):
    """This rank's (view shard, tile shard)."""
    if isinstance(mesh, dict) or tuple(getattr(mesh, "mesh_dim_names", None) or ()) != _DIMS:
        raise ValueError(f"this function runs on the ranks of a DeviceMesh with dims {_DIMS} "
                         f"(make_render_mesh), not on a mesh shape")
    return mesh.get_local_rank("views"), mesh.get_local_rank("tiles")


def _refuse_supersample(config: RenderConfig, what: str) -> None:
    if config.supersample > 1:
        raise ValueError(
            f"{what}: supersample > 1 is not supported on a mesh (the bands are "
            f"built at the output size; ROADMAP queue 3)")


def _padded_height(config: RenderConfig, num_shards: int) -> int:
    """Image height padded so tile rows divide evenly across shards."""
    band = config.tile_size * num_shards
    return -(-config.height // band) * band


def _shard_config(config: RenderConfig, num_shards: int) -> RenderConfig:
    """The contiguous layout's band config: the band's height, sort_bands 1."""
    return dataclasses.replace(
        config, height=_padded_height(config, num_shards) // num_shards, sort_bands=1)


def _pad_scene(scene: GaussianScene, n_pad: int) -> GaussianScene:
    """Every field padded to ``n_pad`` rows with INERT values: identity quats
    (a zero quat would hit the normalize divide), opacity logit -20 (alpha
    ~2e-9), zeros elsewhere. Padded rows project to finite values and are
    sliced away after a gather. Differentiable (a concatenation)."""
    if n_pad == scene.means.shape[0]:
        return scene
    rows = _LocalRows(scene, 0, n_pad)
    return GaussianScene(**{f: getattr(rows, f) for f in _FIELDS})


class _LocalRows:
    """Rows [lo, hi) of a scene, the rows past its end INERT (_pad_scene), in
    the form prepare_splats reads them; ``sh`` is cut out only when it is
    read.

    prepare_splats reads sh after the projection, for the SH evaluation. Of
    the nodes ready, the autograd engine runs the one created last (an
    AccumulateGrad before any), and cutting rows out makes a cheap node:
    cut out before the projection, sh's rows would wait for the projection's
    whole backward, and the SH gradient would complete, and its all-reduce
    start (_psum_in_bwd), only at the backward's end. Cut out when read,
    they run right after the SH evaluation's backward, before the
    projection's."""

    def __init__(self, scene: GaussianScene, lo: int, hi: int):
        self._sh, self._lo, self._hi = scene.sh, lo, hi
        self.means = self._cut(scene.means)
        self.opacities = self._cut(scene.opacities, -20.0)
        self.log_scales = self._cut(scene.log_scales)
        self.quats = self._cut(scene.quats, None)

    def _cut(self, x: torch.Tensor, fill=0.0) -> torch.Tensor:
        """Rows [lo, hi) of ``x``, the rows past its end ``fill`` (None:
        identity quaternions)."""
        n, lo, hi = x.shape[0], self._lo, self._hi
        if hi <= n:
            return x[lo:hi]
        pad = x.new_full((hi - max(lo, n),) + tuple(x.shape[1:]), 0.0 if fill is None else fill)
        if fill is None:
            pad[:, 0] = 1.0
        return torch.cat([x[lo:n], pad]) if lo < n else pad

    @property
    def sh(self) -> torch.Tensor:
        return self._cut(self._sh)


# prepare_splats' per-splat outputs as the columns of one [N, 14] table, so
# that a gather moves them in one collective
_PREPARED = (("mean2d", 2), ("conic", 3), ("rgb", 3), ("alpha", 0), ("depth", 0),
             ("radius", 0), ("extent", 2), ("mask", 0))


def _pack_prepared(sp) -> torch.Tensor:
    cols = []
    for k, w in _PREPARED:
        x = sp[k].to(torch.float32) if k == "mask" else sp[k]
        cols.append(x if w else x[:, None])
    return torch.cat(cols, dim=1)


def _unpack_prepared(packed: torch.Tensor) -> dict:
    out, c = {}, 0
    for k, w in _PREPARED:
        x = packed[:, c:c + max(w, 1)]
        out[k] = x if w else x[:, 0]
        c += max(w, 1)
    out["mask"] = out["mask"] > 0.5
    for k in ("depth", "radius", "extent"):
        out[k] = out[k].detach()
    return out


def prepare_splats_sharded(scene: GaussianScene, camera: Camera, config: RenderConfig, mesh):
    """prepare_splats with the O(N) projection and SH split over the mesh's
    "tiles" dim.

    Each rank prepares its own N/D slice of the padded scene and the 14
    per-splat columns are all-gathered, so every rank bins its rows over the
    whole splat set. prepare_splats works per splat, so the columns equal the
    replicated computation's bit for bit. Gradients: the gather's backward
    sums every rank's cotangent of this rank's slice, so each rank's scene
    gradient is its slice's full gradient and zero elsewhere; the step's
    all-reduce completes it."""
    group = mesh.get_group("tiles")
    nd = dist.get_world_size(group)
    if nd == 1:
        return prepare_splats(scene, camera, config, sort=False)
    d = mesh.get_local_rank("tiles")
    n = scene.means.shape[0]
    chunk = -(-n // nd)
    sp = prepare_splats(_LocalRows(scene, d * chunk, (d + 1) * chunk), camera, config, sort=False)
    return _unpack_prepared(all_gather(_pack_prepared(sp), group)[:n])


def _composite_band(splats, rank: int, num_shards: int, config: RenderConfig):
    """Composite tile shard ``rank``'s contiguous band -> [band_h, W, 4]: the
    band becomes an image of its own height by shifting the splats' y so the
    band's bottom edge is y = 0."""
    cfg_band = _shard_config(config, num_shards)
    # mean2d is registered to the true height: band d's bottom edge sits at
    # height - (d + 1) * band_h (below 0 for a band of padding rows)
    y_bottom = float(config.height - (rank + 1) * cfg_band.height)
    shifted = dict(splats)
    shifted["mean2d"] = splats["mean2d"] - splats["mean2d"].new_tensor([0.0, y_bottom])
    return composite_tiled(shifted, cfg_band)


def _band_grid(config: RenderConfig, num_splats: int, num_shards: int):
    """The interleaved bands' grid: the image's grid with tile rows added
    below it up to the padded height, row_stride = D."""
    ts = config.tile_size
    pad_rows = _padded_height(config, num_shards) // ts - -(-config.height // ts)
    return _grid_from_config(config, num_splats, row_stride=num_shards, pad_rows=pad_rows)


def _composite_band_interleaved(splats, rank: int, num_shards: int, config: RenderConfig):
    """Composite tile shard ``rank``'s INTERLEAVED tile rows (r % D == rank)
    -> [band_h, W, 4], whose row k * ts + j is image tile row k * D + rank,
    pixel row j.

    The grid is the image's grid with tile rows added below it up to the
    padded height (``pad_rows``) and row_stride = D: tile ids, sort keys and
    pixel coordinates are the unsharded render's, and binning enumerates
    only the owned rows (bin_splats ``row_offset``), so each owned tile's
    chain and composite are the unsharded render's, bit for bit. (The JAX
    package instead builds the grid at the padded height and lifts mean2d by
    the padding, which rounds mean2d: its bands can differ from render by
    flips of the 1/256 discard.) Adjacent tile rows carry similar demand, so
    striding balances the shards where contiguous bands do not. Every
    (splat, tile) instance lands in exactly one shard either way."""
    h_pad = _padded_height(config, num_shards)
    mean2d = splats["mean2d"]
    grid = _band_grid(config, mean2d.shape[0], num_shards)
    bins = bin_splats(mean2d.detach(), splats["extent"].detach(), grid,
                      depth=splats["depth"].detach(), row_offset=rank)
    feats = pack_features(mean2d, splats["conic"], splats["rgb"], splats["alpha"])
    out = composite_from_feats(feats, bins, grid)
    img = assemble_image(out, bins["tile_ok"], grid,
                         dataclasses.replace(config, height=h_pad))  # [h_pad, W, 4]
    ts = config.tile_size
    ty_owned = h_pad // ts // num_shards
    w = img.shape[1]
    return img.reshape(ty_owned, num_shards, ts, w, 4)[:, rank].reshape(ty_owned * ts, w, 4)


def _band_fn(band_layout: str):
    if band_layout not in ("interleaved", "contiguous"):
        raise ValueError(f"band_layout {band_layout!r}")
    return _composite_band_interleaved if band_layout == "interleaved" else _composite_band


def _deinterleave_rows(out, config: RenderConfig, num_shards: int):
    """Shard-major stacked interleaved bands [..., D * band_h, W, 4] -> image
    rows [..., h_pad, W, 4]: shard d's band row k * ts + j is image tile row
    k * D + d."""
    ts = config.tile_size
    h_pad = _padded_height(config, num_shards)
    ty_owned = h_pad // ts // num_shards
    lead = tuple(out.shape[:-3])
    w = out.shape[-2]
    img = out.reshape(lead + (num_shards, ty_owned, ts, w, 4))
    k = len(lead)
    return img.transpose(k, k + 1).reshape(lead + (h_pad, w, 4))


def _valid_band_rows(band_h: int, rank: int, num_shards: int, config: RenderConfig,
                     band_layout: str, device):
    """[band_h] bool: the band rows that are image rows (not height padding)."""
    i = torch.arange(band_h, device=device)
    ts = config.tile_size
    if band_layout == "interleaved":
        rows = ((i // ts) * num_shards + rank) * ts + i % ts
    else:
        rows = rank * band_h + i
    return rows < config.height


def band_instance_demands(scene: GaussianScene, camera: Camera, config: RenderConfig,
                          num_shards: int, band_layout: str = "interleaved"):
    """Tile-instance demand of each shard's tile rows -> [num_shards] int32
    tensor (no readback).

    Applies exactly the rect clipping the chosen layout applies
    (interleaved: row_offset on the full strided grid; contiguous: the
    shifted mean2d against the band-height grid), so entry d is the instance
    count shard d's binning enumerates."""
    _band_fn(band_layout)
    with torch.no_grad():
        splats = prepare_splats(scene, camera, config, sort=False)
        n = scene.means.shape[0]
        if band_layout == "interleaved":
            grid = _band_grid(config, n, num_shards)
            return torch.stack([instance_demand(splats["mean2d"], splats["extent"], grid,
                                                row_offset=d) for d in range(num_shards)])
        cfg_band = _shard_config(config, num_shards)
        grid = _grid_from_config(cfg_band, n)
        band_h = cfg_band.height
        return torch.stack([
            instance_demand(splats["mean2d"] - splats["mean2d"].new_tensor(
                [0.0, float(config.height - (d + 1) * band_h)]), splats["extent"], grid)
            for d in range(num_shards)])


def calibrate_config_sharded(scene: GaussianScene, cameras: Camera, config: RenderConfig,
                             mesh, headroom: float = 1.06, bucket: float | None = None,
                             band_layout: str = "interleaved") -> RenderConfig:
    """Capacity calibration for the tile-sharded pipeline -> config with
    ``max_instance_mult`` sized to the PEAK per-band demand over the view(s)
    (one readback), so each rank's instance sort runs at about 1/D of the
    full view's rows.

    One capacity serves every rank, so the peak band governs. The
    power-of-two clamp of capacity_mult_for_demand applies against the band
    geometry (both layouts own 1/D of the tiles). Every rank computes the
    same result from the replicated scene, with no collective: ``mesh`` may
    be the DeviceMesh or its {"views": V, "tiles": T} shape."""
    _refuse_supersample(config, "calibrate_config_sharded")
    num_shards = _shape(mesh)["tiles"]
    cfg_band = _shard_config(config, num_shards)
    peak = torch.stack([band_instance_demands(scene, cam, config, num_shards, band_layout).max()
                        for cam in _views(cameras)]).max()
    mult = capacity_mult_for_demand(int(peak.item()), scene.means.shape[0], cfg_band, headroom,
                                    CAPACITY_BUCKET if bucket is None else bucket)
    return dataclasses.replace(config, max_instance_mult=mult)


def _prepare_fn(mesh, shard_prepare: bool):
    if shard_prepare:
        return lambda s, c, cfg: prepare_splats_sharded(s, c, cfg, mesh)
    return lambda s, c, cfg: prepare_splats(s, c, cfg, sort=False)


def render_sharded(scene: GaussianScene, camera: Camera, config: RenderConfig, mesh,
                   shard_prepare: bool = True, band_layout: str = "interleaved"):
    """One view, tile rows split across the mesh's "tiles" dim -> the whole
    [H, W, 4] image on every rank (the bands all-gathered, deinterleaved and
    cropped).

    Scene and camera are replicated. ``shard_prepare`` splits the projection
    and SH over "tiles" too (the same columns bit for bit;
    prepare_splats_sharded). ``band_layout``: "interleaved" (the default,
    balanced demand) or "contiguous". The tiled pipeline runs whatever
    ``config.pipeline`` says."""
    _refuse_supersample(config, "render_sharded")
    num_shards = _shape(mesh)["tiles"]
    _, t = _coords(mesh)
    band_fn = _band_fn(band_layout)
    splats = _prepare_fn(mesh, shard_prepare)(scene, camera, config)
    out = all_gather(band_fn(splats, t, num_shards, config), mesh.get_group("tiles"))
    if band_layout == "interleaved":
        out = _deinterleave_rows(out, config, num_shards)
    return out[: config.height]


def _rank_views(cameras: Camera, mesh):
    """This rank's slice of a [V]-batched camera (views split over "views")."""
    views = _views(cameras)
    nv = _shape(mesh)["views"]
    if len(views) % nv:
        raise ValueError(f"{len(views)} views do not split over {nv} view shards")
    per = len(views) // nv
    v, _ = _coords(mesh)
    return views[v * per:(v + 1) * per]


def render_batch_sharded(scene: GaussianScene, cameras: Camera, config: RenderConfig, mesh,
                         shard_prepare: bool = True, band_layout: str = "interleaved"):
    """[V]-batched cameras -> [V, H, W, 4] on every rank; views split over
    "views", tile rows over "tiles" (render_sharded per view). The tiled
    pipeline runs whatever ``config.pipeline`` says."""
    _refuse_supersample(config, "render_batch_sharded")
    num_shards = _shape(mesh)["tiles"]
    _, t = _coords(mesh)
    band_fn = _band_fn(band_layout)
    prep = _prepare_fn(mesh, shard_prepare)
    bands = torch.stack([band_fn(prep(scene, cam, config), t, num_shards, config)
                         for cam in _rank_views(cameras, mesh)])  # [Vl, band_h, W, 4]
    # rows first, so the bands gather along dim 0
    out = all_gather(bands.transpose(0, 1), mesh.get_group("tiles")).transpose(0, 1)
    if band_layout == "interleaved":
        out = _deinterleave_rows(out, config, num_shards)
    return all_gather(out[:, : config.height].contiguous(), mesh.get_group("views"))


def shard_targets(targets, config: RenderConfig, mesh, band_layout: str = "interleaved"):
    """[V, H, W, 4] targets -> [V, h_pad, W, 4]: padded to the sharded height,
    rows reordered to the band layout, so that row chunk t holds tile shard
    t's band ("interleaved": the image tile rows r % T == t, in ascending
    order, as _composite_band_interleaved's band rows). ``mesh`` may be the
    DeviceMesh or its {"views": V, "tiles": T} shape."""
    num_shards = _shape(mesh)["tiles"]
    if not isinstance(targets, torch.Tensor):
        targets = torch.as_tensor(targets, dtype=torch.float32)
    h_pad = _padded_height(config, num_shards)
    pad = h_pad - targets.shape[1]
    if pad:
        targets = torch.nn.functional.pad(targets, (0, 0, 0, 0, 0, pad))
    if band_layout == "interleaved" and num_shards > 1:
        ts = config.tile_size
        v, _, w, c = targets.shape
        ty_owned = h_pad // ts // num_shards
        targets = (targets.reshape(v, ty_owned, num_shards, ts, w, c)
                   .transpose(1, 2).reshape(v, h_pad, w, c))
    return targets


def _target_block(targets, config: RenderConfig, mesh):
    """This rank's [V_local, band_h, W, 4] block of shard_targets' full
    tensor, or the local block of a DTensor from local_target_shards."""
    from torch.distributed.tensor import DTensor

    if isinstance(targets, DTensor):
        return targets.to_local()
    shape = _shape(mesh)
    v, t = _coords(mesh)
    per = targets.shape[0] // shape["views"]
    band_h = _padded_height(config, shape["tiles"]) // shape["tiles"]
    return targets[v * per:(v + 1) * per, t * band_h:(t + 1) * band_h]


def _check_step_options(sh_psum_chunks: int, grad_allreduce: str) -> None:
    if grad_allreduce == "ring" or sh_psum_chunks > 1:
        raise NotImplementedError(
            "grad_allreduce='ring' and sh_psum_chunks > 1 are XLA scheduler workarounds "
            "and are not ported (ROADMAP queue 1 item 16)")
    if grad_allreduce != "psum":
        raise ValueError(f"grad_allreduce {grad_allreduce!r}")
    if sh_psum_chunks < 1:
        raise ValueError(f"sh_psum_chunks {sh_psum_chunks} < 1")


# The markers of the replicated steps run inside sh_allreduce_trace(), one a
# step (None outside it: the step then times nothing).
_SH_TRACE = None


@contextlib.contextmanager
def sh_allreduce_trace():
    """Trace the replicated step's in-backward SH all-reduce while inside ->
    a list that gets each step's _psum_in_bwd marker, timed: ``issued`` and
    ``collectives`` (1 and 1 a step; 1 and 0 in a one-rank world) and
    ``window_ms()``, the compute left after the issue to hide the sum under.
    tools/profile_overlap.py and chip_smoke.py read it."""
    global _SH_TRACE
    outer, _SH_TRACE = _SH_TRACE, []
    try:
        yield _SH_TRACE
    finally:
        _SH_TRACE = outer


class _psum_in_bwd:
    """The JAX package's marker of this name: identity forward; the gradient
    summed over the group inside the backward, as soon as it is complete.

    JAX marks the value (a custom_vjp whose backward psums the cotangent).
    Here the marker is a post-accumulate-grad hook on the LEAF, armed for
    one ``backward()``; the forward is not touched::

        with _psum_in_bwd(scene.sh, group) as marker:
            loss.backward()   # the step's last backward that reaches the leaf
        ...                   # other collectives, in the same order on every rank
        marker.wait()         # before anything reads leaf.grad

    When the engine has accumulated the leaf's gradient of that backward
    (``leaf.grad`` then also holds every earlier backward's part), the hook
    starts the sum (all_reduce_async_, one collective) in place on
    ``leaf.grad``; the rest of the backward runs while it travels. The
    engine accumulates a leaf once per backward, as soon as all of its
    gradient is in (AccumulateGrad runs before any other ready node), so
    the sum starts once, right after the SH evaluation's backward and
    before the projection's (the sharded prepare cuts the sh rows out late
    for this: _LocalRows), so before ``means.grad``, which the SH
    evaluation's view directions also feed, is complete. A second
    accumulation while armed raises: it would add into a buffer that a
    collective is writing. If the backward never reached the leaf, the exit
    starts the sum of what ``leaf.grad`` holds (zeros if None), so every
    rank issues the same collectives in the same order. The hook is removed
    on exit, also on an exception.

    ``wait()`` waits for the collective (on NCCL by making the CURRENT
    stream wait: call it on the stream that reads the gradient next) and
    returns ``leaf.grad``. ``issued`` counts the sums started, and
    ``collectives`` those that ran a collective (none in a one-rank group).
    With ``timed``, ``t_issue`` and ``t_end`` are the host clock's start and
    the backward's end (the exit), and ``window_ms()`` the time between them
    by CUDA events for a CUDA leaf, by the host clock otherwise."""

    def __init__(self, leaf: torch.Tensor, group=None, timed: bool = False):
        self.leaf, self.group, self.timed = leaf, group, timed
        self.issued = self.collectives = 0
        self.t_issue = self.t_end = None
        self._events = [None, None]
        self._work = self._handle = None

    def _mark(self, i: int) -> float:
        if self.leaf.is_cuda:
            self._events[i] = torch.cuda.Event(enable_timing=True)
            self._events[i].record()
        return time.perf_counter()

    def _start(self, leaf: torch.Tensor) -> None:
        if self.issued:
            raise RuntimeError("_psum_in_bwd: a second gradient accumulation into a leaf "
                               "whose sum is already in flight")
        if self.timed:
            self.t_issue = self._mark(0)
        self._work = all_reduce_async_(leaf.grad, self.group)
        self.issued, self.collectives = 1, int(self._work is not None)

    def __enter__(self):
        self._handle = self.leaf.register_post_accumulate_grad_hook(self._start)
        return self

    def __exit__(self, exc_type, exc, tb):
        self._handle.remove()
        if exc_type is None:
            if not self.issued:
                if self.leaf.grad is None:
                    self.leaf.grad = torch.zeros_like(self.leaf)
                self._start(self.leaf)
            if self.timed:
                self.t_end = self._mark(1)
        return False

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
        g = self.leaf.grad
        self._work = self.leaf = None  # a traced marker keeps no tensor alive
        return g

    def window_ms(self) -> float:
        if self._events[0] is not None:
            self._events[1].synchronize()
            return self._events[0].elapsed_time(self._events[1])
        return (self.t_end - self.t_issue) * 1e3


def band_loss(splats, target, rank: int, num_shards: int, config: RenderConfig,
              band_layout: str, denom: float):
    """Shard ``rank``'s band of the prepared splats against its ``target``
    block ([band_h, W, 4], shard_targets' rows of that shard): the sum of
    squared errors over the band's image rows (not the height padding), over
    ``denom`` -> a differentiable scalar."""
    band = _band_fn(band_layout)(splats, rank, num_shards, config)
    valid = _valid_band_rows(band.shape[0], rank, num_shards, config, band_layout, band.device)
    return torch.sum(torch.where(valid[:, None, None], (band - target) ** 2, 0.0)) / denom


def _band_losses(params, cams, tgt, config: RenderConfig, mesh, band_layout: str, prepare,
                 last_backward=None):
    """Forward and backward of this rank's band loss for each of its views ->
    the summed loss (a detached device scalar). Each view's loss is over
    V_total x H x W x 4, so the losses summed over the ranks are the mean
    over every view's pixels; its gradient accumulates in the leaves'
    ``.grad``. ``last_backward``, a context manager, is entered around the
    last view's backward alone (the _psum_in_bwd marker: the gradient is
    complete only there)."""
    shape = _shape(mesh)
    _, t = _coords(mesh)
    denom = len(cams) * shape["views"] * config.height * config.width * 4
    total = None
    for i, (cam, tg) in enumerate(zip(cams, tgt)):
        loss = band_loss(prepare(params, cam), tg, t, shape["tiles"], config, band_layout, denom)
        if last_backward is not None and i == len(cams) - 1:
            with last_backward:
                loss.backward()
        else:
            loss.backward()
        total = loss.detach() if total is None else total + loss.detach()
    return total


def _sharded_value_and_grad(scene: GaussianScene, cameras: Camera, targets,
                            config: RenderConfig, mesh, shard_prepare: bool = True,
                            band_layout: str = "interleaved"):
    """The replicated-scene step's loss and gradients -> the loss over every
    view (a device scalar, the same on every rank); the gradients, complete
    and the same on every rank, are left in the leaves' ``.grad``.

    Each rank differentiates its own band loss. The SH gradient is summed
    over the world inside the rank's last backward (_psum_in_bwd), as soon
    as it is complete; then one
    terminal all-reduce of the four small gradients and the loss, flattened
    into one buffer, completes the rest. ``sh`` stays out of it: a second
    sum would count it twice."""
    _refuse_supersample(config, "the sharded train step")
    leaves = [getattr(scene, f) for f in _FIELDS]
    for p in leaves:
        p.grad = None
    prep = _prepare_fn(mesh, shard_prepare)
    marker = _psum_in_bwd(scene.sh, None, timed=_SH_TRACE is not None)
    loss = _band_losses(scene, _rank_views(cameras, mesh), _target_block(targets, config, mesh),
                        config, mesh, band_layout, lambda s, cam: prep(s, cam, config),
                        last_backward=marker)
    small = [p for f, p in zip(_FIELDS, leaves) if f != "sh"]
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in small] + [loss.reshape(1)])
    all_reduce_(flat, None)
    marker.wait()
    if _SH_TRACE is not None:
        _SH_TRACE.append(marker)
    offset = 0
    for p in small:
        p.grad = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
    return flat[-1]


def sharded_train_step(scene: GaussianScene, cameras: Camera, targets, config: RenderConfig,
                       mesh, optimizer=None, sh_psum_chunks: int = 1,
                       grad_allreduce: str = "psum", shard_prepare: bool = True,
                       band_layout: str = "interleaved"):
    """One step of the replicated scene over the mesh -> (loss, grads).

    ``scene`` holds leaf tensors that require grad, the same on every rank.
    Renders this rank's views and band, takes the L2 loss against
    ``targets`` (shard_targets' full [V, h_pad, W, 4] tensor, or a DTensor
    from local_target_shards), and leaves the all-reduced gradients in the
    leaves' ``.grad`` (``grads``, a GaussianScene of them). With a torch
    ``optimizer`` over the leaves it then steps, in place: the optimizer
    holds its own state, so there is no opt_state to pass around. ``loss``
    is a device scalar (the mean over all views). The tiled pipeline runs
    whatever ``config.pipeline`` says.

    The SH gradient is all-reduced inside the backward (_psum_in_bwd).
    ``sh_psum_chunks > 1`` and ``grad_allreduce="ring"`` are XLA scheduler
    workarounds and raise NotImplementedError (ROADMAP queue 1 item 16)."""
    _check_step_options(sh_psum_chunks, grad_allreduce)
    loss = _sharded_value_and_grad(scene, cameras, targets, config, mesh, shard_prepare,
                                   band_layout)
    grads = GaussianScene(**{f: getattr(scene, f).grad for f in _FIELDS})
    if optimizer is not None:
        optimizer.step()
    return loss, grads


def make_sharded_train_step(config: RenderConfig, mesh, optimizer=None, sh_psum_chunks: int = 1,
                            grad_allreduce: str = "psum", shard_prepare: bool = True,
                            band_layout: str = "interleaved"):
    """-> step(scene, cameras, targets): sharded_train_step with these
    arguments bound, returning its (loss, grads). The JAX package builds and
    caches a compiled program here; eager PyTorch compiles nothing, and the
    torch ``optimizer`` holds its own state, so the step takes no
    opt_state."""
    _check_step_options(sh_psum_chunks, grad_allreduce)

    def step(scene: GaussianScene, cameras: Camera, targets):
        return sharded_train_step(scene, cameras, targets, config, mesh, optimizer,
                                  shard_prepare=shard_prepare, band_layout=band_layout)

    return step


def make_sharded_fit_steps(config: RenderConfig, mesh, optimizer, steps: int,
                           sh_psum_chunks: int = 1, grad_allreduce: str = "psum",
                           shard_prepare: bool = True, band_layout: str = "interleaved"):
    """-> fit(scene, cameras, targets): ``steps`` sharded_train_step updates of
    the leaf scene by ``optimizer`` (in place) -> losses [steps], a device
    tensor: nothing is read back inside the chunk."""
    _check_step_options(sh_psum_chunks, grad_allreduce)
    _refuse_supersample(config, "make_sharded_fit_steps")

    def fit(scene, cameras, targets):
        losses = []
        for _ in range(steps):
            losses.append(_sharded_value_and_grad(scene, cameras, targets, config, mesh,
                                                  shard_prepare, band_layout))
            optimizer.step()
        return torch.stack(losses)

    return fit


# --------------------- ZeRO-style parameter sharding ---------------------
#
# The step above keeps the scene replicated: every rank holds all N splats'
# parameters and Adam state, and all-reduces of the whole gradient complete
# each step. prepare_splats is the only consumer of the parameters
# and works per splat, so the parameters themselves can be split, over BOTH
# mesh dims: rank (v, t) owns chunk t * V + v of the padded scene, as leaf
# tensors of its own, and its optimizer holds the Adam state of that chunk
# alone.
# - over "views" the PARAMETERS are all-gathered (each views-row renders its
#   own cameras, so features cannot cross there): the gather of the chunks of
#   one tile shard's ranks gives the contiguous block t; its backward
#   reduce-scatters the block's gradient back to the chunks;
# - over "tiles" the prepared FEATURES are all-gathered (14 columns a splat),
#   whose backward sums the cotangents: no gradient all-reduce remains.


def pad_scene_to_mesh(scene: GaussianScene, mesh):
    """The scene padded so the splat count divides the whole device count
    (views x tiles) -> (padded scene, true N). The padding rows are inert
    (_pad_scene) and sit at the tail, so the gathered [:N] drops them.
    ``mesh`` may be the DeviceMesh or its {"views": V, "tiles": T} shape."""
    shape = _shape(mesh)
    d = shape["tiles"] * shape["views"]
    n = scene.means.shape[0]
    return _pad_scene(scene, -(-n // d) * d), n


def _pack_params(scene: GaussianScene) -> torch.Tensor:
    """[n, 11 + 3K]: the five fields of each splat in one row."""
    return torch.cat([getattr(scene, f).reshape(scene.means.shape[0], -1) for f in _FIELDS], 1)


def _unpack_params(packed: torch.Tensor, sh_k: int) -> GaussianScene:
    n, c, out = packed.shape[0], 0, {}
    for f, shape in (("means", (3,)), ("sh", (3, sh_k)), ("opacities", ()),
                     ("log_scales", (3,)), ("quats", (4,))):
        w = 1
        for s in shape:
            w *= s
        # a contiguous copy: the same memory layout as a scene's own fields,
        # so prepare_splats computes the same bits
        out[f] = packed[:, c:c + w].reshape((n,) + shape).contiguous()
        c += w
    return GaussianScene(**out)


def _zero_value_and_grad(chunk: GaussianScene, cams, tgt, config: RenderConfig, mesh,
                         num_splats: int, band_layout: str):
    """One ZeRO step's loss and gradients -> the loss over every view (a
    device scalar); the gradient of this rank's chunk, complete over both
    dims, is left in the chunk leaves' ``.grad``."""
    leaves = [getattr(chunk, f) for f in _FIELDS]
    sh_k = chunk.sh.shape[-1]
    with torch.no_grad():
        row = all_gather(_pack_params(chunk), mesh.get_group("views"))
    row.requires_grad_(True)  # the block of this tile shard: rows [t*V*c, (t+1)*V*c)
    block = _unpack_params(row, sh_k)
    tiles = mesh.get_group("tiles")

    def prepare(block, cam):
        sp = prepare_splats(block, cam, config, sort=False)
        return _unpack_prepared(all_gather(_pack_prepared(sp), tiles)[:num_splats])

    loss = _band_losses(block, cams, tgt, config, mesh, band_layout, prepare)
    g = row.grad if row.grad is not None else torch.zeros_like(row)
    g_chunk = _unpack_params(reduce_scatter(g, mesh.get_group("views")), sh_k)
    for f, p in zip(_FIELDS, leaves):
        p.grad = getattr(g_chunk, f).contiguous()
    return all_reduce_(loss.clone(), None)


def make_zero_fit_steps(config: RenderConfig, mesh, optimizer, steps: int, num_splats: int,
                        band_layout: str = "interleaved"):
    """-> fit(chunk, cameras, targets): ``steps`` ZeRO updates of this rank's
    chunk (leaf tensors, updated in place by ``optimizer``, a torch optimizer
    over them) -> losses [steps], a device tensor.

    ``targets`` is shard_targets' full tensor or a DTensor from
    local_target_shards. The forward is the replicated sharded step's bit
    for bit (prepare works per splat and the gathers reassemble the same
    columns); the gradients are the same sums in another order."""
    _refuse_supersample(config, "make_zero_fit_steps")

    def fit(chunk, cameras, targets):
        cams = _rank_views(cameras, mesh)
        tgt = _target_block(targets, config, mesh)
        losses = []
        for _ in range(steps):
            losses.append(_zero_value_and_grad(chunk, cams, tgt, config, mesh, num_splats,
                                               band_layout))
            optimizer.step()
        return torch.stack(losses)

    return fit


def _chunk_of(padded: GaussianScene, mesh) -> tuple:
    shape = _shape(mesh)
    v, t = _coords(mesh)
    c = padded.means.shape[0] // (shape["views"] * shape["tiles"])
    k = t * shape["views"] + v
    return k * c, (k + 1) * c


def _gather_chunks(chunk: GaussianScene, mesh, n: int) -> GaussianScene:
    """Every rank's chunk, reassembled in splat order -> the first n splats."""
    with torch.no_grad():
        block = all_gather(_pack_params(chunk), mesh.get_group("views"))
        full = all_gather(block, mesh.get_group("tiles"))[:n]
    return _unpack_params(full, chunk.sh.shape[-1])


def zero_fit_steps(scene: GaussianScene, cameras: Camera, targets, config: RenderConfig,
                   mesh, optimizer, steps: int, band_layout: str = "interleaved"):
    """Pad, split, run make_zero_fit_steps once, gather -> (scene, optimizer,
    losses [steps] device tensor).

    ``targets`` are the RAW [V, H, W, 4] images (shard_targets is applied
    here). ``optimizer`` is a factory, called with this rank's chunk (a
    GaussianScene of leaf tensors) and returning a torch optimizer whose
    parameters are those five leaves in field order (train.default_optimizer
    is one); or the optimizer an earlier call returned, to continue: the
    chunk of ``scene`` is then copied into its parameters and its state
    (Adam's moments of this chunk alone) carries on. The returned scene is
    every rank's chunk gathered, the first N splats, detached."""
    _refuse_supersample(config, "zero_fit_steps")
    padded, n = pad_scene_to_mesh(scene, mesh)
    lo, hi = _chunk_of(padded, mesh)
    if isinstance(optimizer, torch.optim.Optimizer):
        opt = optimizer
        params = [p for g in opt.param_groups for p in g["params"]]
        if len(params) != len(_FIELDS) or any(
                p.shape != getattr(padded, f)[lo:hi].shape for p, f in zip(params, _FIELDS)):
            raise ValueError("zero_fit_steps: the optimizer's parameters are not this "
                             "rank's chunk of the scene")
        with torch.no_grad():
            for p, f in zip(params, _FIELDS):
                p.copy_(getattr(padded, f)[lo:hi])
        chunk = GaussianScene(*params)
    else:
        chunk = GaussianScene(**{f: getattr(padded, f)[lo:hi].detach().clone().requires_grad_(True)
                                 for f in _FIELDS})
        opt = optimizer(chunk)
        params = [p for g in opt.param_groups for p in g["params"]]
        if len(params) != len(_FIELDS) or any(
                p is not getattr(chunk, f) for p, f in zip(params, _FIELDS)):
            raise ValueError("zero_fit_steps: the optimizer must hold the chunk's five "
                             "leaves in field order")
    full = shard_targets(targets, config, mesh, band_layout).to(chunk.means.device)
    fit = make_zero_fit_steps(config, mesh, opt, steps, n, band_layout)
    losses = fit(chunk, cameras, full)
    return _gather_chunks(chunk, mesh, n), opt, losses
