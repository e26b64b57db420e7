"""Projection, SH and transform math (plain PyTorch)."""

from splatapult_tpu_torch.core import transforms, sh, project

__all__ = ["transforms", "sh", "project"]
