"""Multi-process bring-up on torch.distributed: one process per device.

Call initialize_distributed() first in every process (``torchrun
--nproc-per-node N`` sets the environment it reads), build the mesh with
make_pod_mesh() on every rank alike, and use parallel.mesh as on one host:
the tiles dim is the fast-varying one, so a host's tile shards sit on its own
cards. Each process needs only the targets of its own views and bands:
local_target_shards wraps that block as a DTensor over the mesh.
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

from splatapult_tpu_torch._device import DEFAULT_DEVICE, resolve_device

_log = logging.getLogger(__name__)


def initialize_distributed(coordinator_address=None, num_processes=None, process_id=None,
                           device=DEFAULT_DEVICE) -> bool:
    """init_process_group from the arguments or from torchrun's environment
    (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK) -> True when a
    process group is up (also when it already was), False single-process
    (neither arguments nor that environment name a world).

    ``coordinator_address`` is "host:port" of rank 0. On a CUDA ``device``
    (the default; RuntimeError without a card unless "cpu" is asked for) the
    process takes card LOCAL_RANK and NCCL; on the CPU, gloo."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return True
    env = os.environ
    world = num_processes if num_processes is not None else env.get("WORLD_SIZE")
    rank = process_id if process_id is not None else env.get("RANK")
    if world is None or rank is None or (coordinator_address is None
                                         and "MASTER_ADDR" not in env):
        _log.info("single-process mode: no world size, rank or coordinator given")
        return False
    world, rank = int(world), int(rank)
    if dev.type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank % torch.cuda.device_count())))
        backend = "nccl"
    else:
        backend = "gloo"
    init_method = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    _log.info("distributed: rank %d of %d over %s", rank, world, backend)
    return True


def make_pod_mesh(num_view_shards: int = 1, device_type=None):
    """The ("views", "tiles") mesh over the whole world (every rank calls it
    alike): world / num_view_shards tile shards."""
    from splatapult_tpu_torch.parallel.mesh import make_render_mesh

    return make_render_mesh(num_tile_shards=dist.get_world_size() // num_view_shards,
                            num_view_shards=num_view_shards, device_type=device_type)


def local_target_shards(targets_for_local_bands, config, mesh):
    """This process's block of the padded, band-ordered targets
    ([V / views, h_pad / tiles, W, 4]: its views by its tile shard's rows, as
    shard_targets orders them) -> a DTensor over ``mesh``, sharded on dim 0
    by "views" and on dim 1 by "tiles"; ``.to_local()`` is the block again.
    The global shape follows from the block and the mesh, with no
    collective. (``config`` is unused: the JAX function's signature.)"""
    from torch.distributed.tensor import DTensor, Shard

    return DTensor.from_local(targets_for_local_bands, mesh, [Shard(0), Shard(1)])
