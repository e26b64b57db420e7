"""splatapult_tpu_torch — the PyTorch/CUDA port of splatapult_tpu for one H100.

A second package beside the JAX one, sub-package for sub-package (``io/``,
``core/``, ``ops/``, ``utils/``, ``reference/``, ``render.py``, ``train.py``,
``diagnostics.py``, ``cli.py``), plus ``kernels/`` (the hand-written CUDA
kernels and their loader) and ``convert.py`` (carry parameters across from the
JAX package). It imports torch and numpy only.

The viewer: one view, a camera path (``render_batch``) or a stereo pair
(``Camera.stereo_pair``) through the tiled pipeline (prepare -> bin/sort ->
gather -> composite -> assemble, with the expand and composite-forward kernels
written for sm_90a) or, below 4096 splats, the global pipeline; supersampling;
the cameras.json / <ply>_vr.json host side and the CLI. Training on one
device: autograd through either pipeline, with the composite-backward kernel
and its per-splat tail on the tiled one, and ``train.fit_scene``. Entry points
run on the GPU unless the caller passes ``device="cpu"``.
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
    render_batch,
)

__all__ = [
    "GaussianScene",
    "load_gaussian_ply",
    "save_gaussian_ply",
    "RenderConfig",
    "Camera",
    "calibrate_config",
    "render",
    "render_batch",
]
