"""Hand-written CUDA kernels for sm_90a and their loader.

``csrc/*.cu`` hold the kernels behind a plain C interface; ``_build`` compiles
them with nvcc at first use into the git-ignored ``_build/`` directory and
binds them with ctypes. Importing this package touches neither nvcc nor CUDA:
the wrappers in ``ops/`` call ``_build.load()`` only when handed a CUDA
tensor.

``LAUNCH_COUNTS`` counts kernel launches per wrapper (incremented where the
wrapper launches its kernel and nowhere else), so a run can show that a path
really went through the kernels.
"""

from __future__ import annotations

LAUNCH_COUNTS = {"expand_fill": 0, "composite_fwd": 0}


def reset_launch_counts() -> None:
    for k in LAUNCH_COUNTS:
        LAUNCH_COUNTS[k] = 0

