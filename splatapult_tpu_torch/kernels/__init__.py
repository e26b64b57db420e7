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

LAUNCH_COUNTS = {"expand_fill": 0, "composite_fwd_segments": 0, "composite_fwd_combine": 0,
                 "composite_bwd": 0}
# the same for the ablation microbenchmark's kernels (tools/microbench_kernel.py,
# tools/microbench_bwdk.py), per launch and variant: "fwd_segments[noscan]",
# "fwd_combine[sub2]", "bwd[nomom]", ...; kept apart, so that the render and
# training paths' counts stay the four above
ABLATION_LAUNCH_COUNTS = {
    **{f"fwd_{launch}[{v}]": 0 for launch in ("segments", "combine")
       for v in ("full", "noscan", "noexp", "scan_bf16", "nowork", "sub2", "sub4")},
    **{f"bwd[{v}]": 0 for v in ("full", "nowork", "noscan", "noscan2", "nomom", "tri_bf16")},
}


def reset_launch_counts() -> None:
    for counts in (LAUNCH_COUNTS, ABLATION_LAUNCH_COUNTS):
        for k in counts:
            counts[k] = 0

