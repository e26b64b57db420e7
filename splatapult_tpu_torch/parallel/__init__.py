"""Multi-device rendering and training on torch.distributed (mesh.py) and
the multi-process bring-up (distributed.py)."""

from splatapult_tpu_torch.parallel.mesh import (
    band_instance_demands,
    calibrate_config_sharded,
    make_render_mesh,
    make_sharded_fit_steps,
    make_zero_fit_steps,
    pad_scene_to_mesh,
    prepare_splats_sharded,
    render_batch_sharded,
    render_sharded,
    shard_targets,
    sharded_train_step,
    zero_fit_steps,
)

__all__ = [
    "band_instance_demands",
    "calibrate_config_sharded",
    "make_render_mesh",
    "make_sharded_fit_steps",
    "make_zero_fit_steps",
    "pad_scene_to_mesh",
    "prepare_splats_sharded",
    "render_sharded",
    "render_batch_sharded",
    "shard_targets",
    "sharded_train_step",
    "zero_fit_steps",
]
