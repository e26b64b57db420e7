"""The float64 numpy oracle rasterizer (a copy of the JAX package's; numpy
only)."""

from splatapult_tpu_torch.reference.raster import reference_render

__all__ = ["reference_render"]
