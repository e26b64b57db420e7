// The three instance-row layouts of the composite kernels (composite_fwd.cu,
// composite_bwd.cu), for sm_90a: one decode per layout, each giving the nine
// fields (mean_x, mean_y, qa, qb, qc, ln_alpha, r, g, b) in f32. They replace
// splatapult_tpu/ops/composite.py::_unpack_feats, and give the same values as
// the plain decode (ops/composite.py::unpack_feats) bit for bit:
//   kRowF32x16  64 B: 16 f32, the fields in columns 0-8 (the exact layout);
//   kRowI32x8   32 B: the geometry's six f32 bit patterns, then r << 16 | g
//               and b << 16 as 16-bit signed fixed point, step 2^-12
//               (_pack_color_feats);
//   kRowI32x4   16 B: mean_x << 16 | mean_y as unsigned 16-bit fixed point
//               over [-W, 2W) x [-H, 2H); f16(qa) << 16 | f16(qb);
//               f16(qc) << 16 | f16(ln_alpha); r:11 | g:11 | b:10 unsigned
//               fixed point over [-4, 4) (_pack_feats16).
// IEEE f16 -> f32 is exact (subnormals included), so __half2float gives what
// the JAX package's integer decode gives. The mean decode is q * step - W
// with the step passed in (the f32 value the JAX decode uses), each
// operation rounded on its own (__fmul_rn, __fsub_rn: no contraction into
// an fma, which would round once). The colour scales are powers of two, so
// there every product is exact.
//
// Rows are read where they lie (shared memory in both kernels) by 16-byte
// vector loads: a row's bytes, and each table of rows, are 16-byte aligned.
#pragma once

#include <cuda_fp16.h>

enum RowLayoutCode : int { kRowF32x16 = 0, kRowI32x8 = 1, kRowI32x4 = 2 };

// What the i32x4 mean decode needs (unused by the other layouts).
struct MeanDecode {
  float step_x, step_y;  // pixels per step of the 16-bit fields: 3W/65536, 3H/65536
  float off_x, off_y;    // W and H: the fields count from -W and -H
};

struct RowGeometry {
  float mx, my, qa, qb, qc, lna;
};

template <int kLayout>
struct RowLayout;

template <>
struct RowLayout<kRowF32x16> {
  static constexpr int kBytes = 64;
  __device__ __forceinline__ static RowGeometry geometry(const unsigned char* row,
                                                         const MeanDecode&) {
    const float4 g0 = *reinterpret_cast<const float4*>(row);      // mx my qa qb
    const float2 g1 = *reinterpret_cast<const float2*>(row + 16); // qc lna
    return {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y};
  }
  __device__ __forceinline__ static RowGeometry decode(const unsigned char* row,
                                                       const MeanDecode&, float& r, float& g,
                                                       float& b) {
    const float4 g0 = *reinterpret_cast<const float4*>(row);      // mx my qa qb
    const float4 g1 = *reinterpret_cast<const float4*>(row + 16); // qc lna r g
    r = g1.z;
    g = g1.w;
    b = *reinterpret_cast<const float*>(row + 32);
    return {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y};
  }
};

template <>
struct RowLayout<kRowI32x8> {
  static constexpr int kBytes = 32;
  __device__ __forceinline__ static RowGeometry geometry(const unsigned char* row,
                                                         const MeanDecode&) {
    const float4 g0 = *reinterpret_cast<const float4*>(row);      // mx my qa qb
    const float2 g1 = *reinterpret_cast<const float2*>(row + 16); // qc lna
    return {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y};
  }
  __device__ __forceinline__ static RowGeometry decode(const unsigned char* row,
                                                       const MeanDecode&, float& r, float& g,
                                                       float& b) {
    const float4 g0 = *reinterpret_cast<const float4*>(row);  // mx my qa qb
    const int4 w = *reinterpret_cast<const int4*>(row + 16);  // qc lna | r<<16|g | b<<16
    constexpr float kInv = 1.0f / 4096.0f;                      // COLOR_SCALE
    r = static_cast<float>(w.z >> 16) * kInv;  // arithmetic shifts: signed fields
    g = static_cast<float>(static_cast<int>(static_cast<unsigned>(w.z) << 16) >> 16) * kInv;
    b = static_cast<float>(w.w >> 16) * kInv;
    return {g0.x, g0.y, g0.z, g0.w, __int_as_float(w.x), __int_as_float(w.y)};
  }
};

template <>
struct RowLayout<kRowI32x4> {
  static constexpr int kBytes = 16;
  __device__ __forceinline__ static float f16_field(unsigned bits) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(bits & 0xFFFFu)));
  }
  __device__ __forceinline__ static RowGeometry geometry_of(const uint4& w,
                                                            const MeanDecode& md) {
    return {__fsub_rn(__fmul_rn(__uint2float_rn(w.x >> 16), md.step_x), md.off_x),
            __fsub_rn(__fmul_rn(__uint2float_rn(w.x & 0xFFFFu), md.step_y), md.off_y),
            f16_field(w.y >> 16), f16_field(w.y), f16_field(w.z >> 16), f16_field(w.z)};
  }
  __device__ __forceinline__ static RowGeometry geometry(const unsigned char* row,
                                                         const MeanDecode& md) {
    return geometry_of(*reinterpret_cast<const uint4*>(row), md);
  }
  __device__ __forceinline__ static RowGeometry decode(const unsigned char* row,
                                                       const MeanDecode& md, float& r, float& g,
                                                       float& b) {
    const uint4 w = *reinterpret_cast<const uint4*>(row);
    r = __uint2float_rn((w.w >> 21) & 0x7FFu) * (1.0f / 256.0f) - 4.0f;  // COLOR11_SCALE
    g = __uint2float_rn((w.w >> 10) & 0x7FFu) * (1.0f / 256.0f) - 4.0f;
    b = __uint2float_rn(w.w & 0x3FFu) * (1.0f / 128.0f) - 4.0f;           // COLOR10_SCALE
    return geometry_of(w, md);
  }
};
