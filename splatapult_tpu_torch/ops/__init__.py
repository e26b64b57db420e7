"""Tiled pipeline: binning, composite and image assembly."""

from splatapult_tpu_torch.ops.binning import instance_demand
from splatapult_tpu_torch.ops.tiled import composite_tiled

__all__ = ["composite_tiled", "instance_demand"]
