"""Real spherical-harmonics basis (degree 0..3) and radiance evaluation.

The basis constants and sign conventions are exactly those of the reference
vertex shader (ref: shader/splat_vert.glsl:51-127), which in turn match the
INRIA 3DGS trainer, so colors are bit-comparable given the same coefficients.
The final color is offset by +0.5 per channel (ref: shader/splat_vert.glsl:126).
"""

from __future__ import annotations

import torch

from splatapult_tpu_torch.core.transforms import stack_last

# ref: shader/splat_vert.glsl:63-105 (comments there give the closed forms)
SH_K0 = 0.28209479177387814  # 1 / (2 sqrt(pi))
SH_K1 = 0.4886025119029199  # sqrt(3) / (2 sqrt(pi))
SH_K2 = 1.0925484305920792  # sqrt(15) / (2 sqrt(pi))
SH_K3 = 0.31539156525252005  # sqrt(5) / (4 sqrt(pi))
SH_K4 = 0.5462742152960396  # sqrt(15) / (4 sqrt(pi))
SH_K5 = 0.5900435899266435  # sqrt(70) / (8 sqrt(pi))
SH_K6 = 2.8906114426405543  # sqrt(105) / (2 sqrt(pi))
SH_K7 = 0.4570457994644658  # sqrt(42) / (8 sqrt(pi))
SH_K8 = 0.37317633259011546  # sqrt(7) / (4 sqrt(pi))
SH_K9 = 1.4453057213202771  # sqrt(105) / (4 sqrt(pi))

NUM_COEFFS = {0: 1, 1: 4, 2: 9, 3: 16}


def sh_basis(dirs, degree: int):
    """Evaluate the SH basis for unit directions [..., 3] -> [..., K].

    K = (degree+1)^2. Row k matches b[k] in the reference shader
    (ref: shader/splat_vert.glsl:59-105).
    """
    if degree not in NUM_COEFFS:
        raise ValueError(f"degree must be 0..3, got {degree}")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    one = torch.ones_like(x)
    cols = [SH_K0 * one]
    if degree >= 1:
        cols += [-SH_K1 * y, SH_K1 * z, -SH_K1 * x]
    if degree >= 2:
        x2, y2, z2 = x * x, y * y, z * z
        cols += [
            SH_K2 * y * x,
            -SH_K2 * y * z,
            SH_K3 * (3.0 * z2 - 1.0),
            -SH_K2 * x * z,
            SH_K4 * (x2 - y2),
        ]
    if degree >= 3:
        cols += [
            -SH_K5 * y * (3.0 * x2 - y2),
            SH_K6 * y * x * z,
            -SH_K7 * y * (5.0 * z2 - 1.0),
            SH_K8 * z * (5.0 * z2 - 3.0),
            -SH_K7 * x * (5.0 * z2 - 1.0),
            SH_K9 * z * (x2 - y2),
            -SH_K5 * x * (x2 - 3.0 * y2),
        ]
    return stack_last(cols)


def eval_sh_radiance(sh, dirs, degree: int | None = None):
    """SH coefficients [..., 3, K] + unit view dirs [..., 3] -> RGB radiance [..., 3].

    color = 0.5 + sum_k b_k * sh_k per channel (ref: shader/splat_vert.glsl:107-126).
    ``degree`` may truncate evaluation below the stored K (the --nosh analog when 0).
    """
    k_stored = sh.shape[-1]
    if degree is None:
        degree = {1: 0, 4: 1, 9: 2, 16: 3}[k_stored]
    k_used = NUM_COEFFS[degree]
    if k_used > k_stored:
        raise ValueError(f"scene stores {k_stored} SH coeffs; degree {degree} needs {k_used}")
    basis = sh_basis(dirs, degree)  # [..., K]
    # one pass over the coefficients in their stored (contiguous) order; a
    # per-coefficient loop would re-read every cache line of ``sh`` K times
    acc = (sh[..., :k_used] * basis[..., None, :]).sum(dim=-1)
    return 0.5 + acc
