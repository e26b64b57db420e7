"""splatapult_tpu_torch — the PyTorch/CUDA port of splatapult_tpu for one H100.

A second package beside the JAX one, sub-package for sub-package (``io/``,
``core/``, ``ops/``, ``utils/``, ``render.py``, ``cli.py``), plus ``kernels/``
(the hand-written CUDA kernels and their loader) and ``convert.py`` (carry
parameters across from the JAX package). It imports torch and numpy only.

Ported so far: the viewer path — one forward render of one view through the
tiled pipeline (prepare -> bin/sort -> gather -> composite -> assemble), with
the expand and composite-forward kernels written for sm_90a. Entry points run
on the GPU unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from splatapult_tpu_torch.io.gaussians import (
    GaussianScene,
    load_gaussian_ply,
    save_gaussian_ply,
)
from splatapult_tpu_torch.render import (
    Camera,
    RenderConfig,
    calibrate_config,
    render,
)

__all__ = [
    "GaussianScene",
    "load_gaussian_ply",
    "save_gaussian_ply",
    "RenderConfig",
    "Camera",
    "calibrate_config",
    "render",
]
