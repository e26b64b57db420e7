// Which instance rows can reach a warp's pixels at all: the per-warp row
// lists of the composite kernels (composite_fwd.cu, composite_bwd.cu), for
// sm_90a. Per sub-chunk of 32 rows, lane r of a warp takes row r and asks
// row_may_touch whether its gaussian can exceed the discard anywhere in the
// rectangle of the warp's pixel centres (warp_rect); a ballot is the list and
// the warp evaluates only the listed rows per pixel. A row that is not listed
// has weight 0 at every pixel of the warp, so skipping it changes no bit of
// the result.
#pragma once

// Can the gaussian of one instance row put a weight above the discard on any
// pixel centre inside the rectangle [xlo, xhi] x [ylo, yhi]? Conservative:
// "no" is certain, "yes" means decide per pixel. For a gaussian the exponent
// qh is a concave quadratic around the mean, so its largest value over the
// rectangle is ln_alpha if the mean lies inside, and otherwise is taken on one
// of the four edges, where it is a parabola in one variable: its vertex,
// clamped to the edge (found with the fast division: near its vertex a
// parabola does not feel a last-bit error of the position). The row is ruled
// out when that largest value stays 0.01 below the discard (the margin covers
// the rounding of both sides). A row whose form is not concave (or holds a
// NaN) is never ruled out here.
__device__ __forceinline__ float edge_max(float q_fixed, float q_cross, float q_free,
                                          float fixed, float lo, float hi) {
  // max over s in [lo, hi] of q_fixed * fixed^2 + q_cross * fixed * s + q_free * s^2
  const float s = fminf(fmaxf(__fdividef(-0.5f * q_cross * fixed, q_free), lo), hi);
  return q_fixed * fixed * fixed + (q_cross * fixed + q_free * s) * s;
}

__device__ __forceinline__ bool row_may_touch(float mx, float my, float qa, float qb,
                                              float qc, float lna, float ln_cutoff,
                                              float xlo, float xhi, float ylo, float yhi) {
  if (!(qa <= 0.0f && qc <= 0.0f && 4.0f * qa * qc >= qb * qb)) return true;
  const float x0 = xlo - mx, x1 = xhi - mx, y0 = ylo - my, y1 = yhi - my;
  float qmax = 0.0f;
  if (!(x0 <= 0.0f && x1 >= 0.0f && y0 <= 0.0f && y1 >= 0.0f)) {
    qmax = fmaxf(fmaxf(edge_max(qa, qb, qc, x0, y0, y1), edge_max(qa, qb, qc, x1, y0, y1)),
                 fmaxf(edge_max(qc, qb, qa, y0, x0, x1), edge_max(qc, qb, qa, y1, x0, x1)));
  }
  return !(qmax + lna <= ln_cutoff - 0.01f);
}

// The rectangle of the pixel centres (px, py) of the warp's lanes that hold a
// pixel (an empty rectangle, lo > hi, when none does). All 32 lanes must call
// it; every lane returns the same rectangle.
__device__ __forceinline__ void warp_rect(float px, float py, bool has_pixel, float& xlo,
                                          float& xhi, float& ylo, float& yhi) {
  xlo = has_pixel ? px : 3e38f;
  xhi = has_pixel ? px : -3e38f;
  ylo = has_pixel ? py : 3e38f;
  yhi = has_pixel ? py : -3e38f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    xlo = fminf(xlo, __shfl_xor_sync(0xffffffffu, xlo, off));
    xhi = fmaxf(xhi, __shfl_xor_sync(0xffffffffu, xhi, off));
    ylo = fminf(ylo, __shfl_xor_sync(0xffffffffu, ylo, off));
    yhi = fmaxf(yhi, __shfl_xor_sync(0xffffffffu, yhi, off));
  }
}

// The pixel (row-major index in the tile) of thread `tid`: warps are 8 x 4
// patches of the tile where its side is a multiple of 8 (a patch is touched
// by two thirds as many rows as a 32 x 1 strip), and 32 x 1 strips otherwise.
__device__ __forceinline__ int patch_pixel(int tid, int tile_size) {
  if ((tile_size & 7) != 0) return tid;
  const int warp = tid >> 5, lane = tid & 31;
  const int across = tile_size >> 3;  // patches per tile row
  return ((warp / across) * 4 + (lane >> 3)) * tile_size + (warp % across) * 8 + (lane & 7);
}
