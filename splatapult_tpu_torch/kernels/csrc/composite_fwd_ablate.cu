// composite_fwd_ablate: the composite forward (composite_fwd.cu) with one
// piece taken out at a time, for sm_90a: the kernels of the ablation
// microbenchmark splatapult_tpu_torch/tools/microbench_kernel.py.
//
// Replaces the TPU kernels of tools/microbench_kernel.py: the pallas_call at
// :149 (make_kernel(variant), the block body of ops/composite.py::_fwd_kernel
// with one piece removed: full, noscan, noexp, scan_bf16, nowork) and the one
// at :224 (that body over SUB = 2, 4 blocks a grid step). Each variant here is
// composite_fwd.cuh's body instantiated with a variant (see that header for
// what each removes) for the f32x16 rows and f32 output rows, the layout the
// TPU tool ablates; SUB = 2, 4 become segments of 16 and 32 blocks with the
// shipped arithmetic, whose values stay right (the TPU variant's are wrong
// by design: its sub-blocks may straddle tiles). Variant kFwdFull with
// kSegBlocks is the shipped code compiled a second time, so the tool can hold
// it against the shipped kernel bit for bit and in time. The variants'
// instantiations live in this translation unit alone, so composite_fwd.cu's
// are the ones it always had.
//
// Bound: each variant does at most the shipped kernel's work (the sub-blocked
// ones the same work in longer segments), so the tool states the shipped
// function's bound (tools/profile_phases.composite_bounds) beside them.

#include <type_traits>

#include "composite_fwd.cuh"

namespace {

template <int V>
using Variant = std::integral_constant<int, V>;

// launch(Variant<v>, Variant<seg>) for the runtime (variant, segment length)
// pairs that are built: every variant with kSegBlocks, and the shipped
// arithmetic with 2 and 4 times as long segments.
template <typename Launch>
int by_variant(int variant, int seg_blocks, Launch&& launch) {
  if (seg_blocks == kSegBlocks) {
    using K = Variant<kSegBlocks>;
    switch (variant) {
      case kFwdFull: return launch(Variant<kFwdFull>{}, K{});
      case kFwdNoScan: return launch(Variant<kFwdNoScan>{}, K{});
      case kFwdNoExp: return launch(Variant<kFwdNoExp>{}, K{});
      case kFwdScanBf16: return launch(Variant<kFwdScanBf16>{}, K{});
      case kFwdNoWork: return launch(Variant<kFwdNoWork>{}, K{});
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (variant != kFwdFull) return static_cast<int>(cudaErrorInvalidValue);
  if (seg_blocks == 2 * kSegBlocks) return launch(Variant<kFwdFull>{}, Variant<2 * kSegBlocks>{});
  if (seg_blocks == 4 * kSegBlocks) return launch(Variant<kFwdFull>{}, Variant<4 * kSegBlocks>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

bool bad_shape(int tile_size, int block) {
  // the variants find a block's end by 32-row sub-chunk
  return tile_size * tile_size > kMaxThreads || block <= 0 || block % kSubRows != 0;
}

}  // namespace

extern "C" int splat_ablate_fwd_segments(int variant, int seg_blocks, const void* inst,
                                         const void* tile_start, const void* tile_nblk,
                                         void* locs, int num_segments, int num_tiles,
                                         int tiles_x, int tile_size, int height, int block,
                                         float ln_cutoff, int use_cutoff, void* stream) {
  if (num_tiles <= 0 || num_segments <= 0) return 0;
  if (bad_shape(tile_size, block)) return static_cast<int>(cudaErrorInvalidValue);
  const MeanDecode md{0.0f, 0.0f, 0.0f, 0.0f};  // f32x16 rows decode no mean
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_variant(variant, seg_blocks, [&](auto v, auto k) {
    return launch_segments<kRowF32x16, decltype(v)::value, decltype(k)::value>(
        inst, tile_start, tile_nblk, locs, num_segments, num_tiles, tiles_x, tile_size, height,
        block, ln_cutoff, use_cutoff, md, s);
  });
}

extern "C" int splat_ablate_fwd_combine(int variant, int seg_blocks, const void* inst,
                                        const void* tile_start, const void* tile_nblk,
                                        void* locs, void* out, void* tile_walked,
                                        int store_prefix, int num_tiles, int tiles_x,
                                        int tile_size, int height, int block, float ln_cutoff,
                                        int use_cutoff, float early_stop_eps, void* stream) {
  if (num_tiles <= 0) return 0;
  if (bad_shape(tile_size, block) || (store_prefix && tile_walked == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const MeanDecode md{0.0f, 0.0f, 0.0f, 0.0f};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_variant(variant, seg_blocks, [&](auto v, auto k) {
    return launch_combine<kRowF32x16, float, decltype(v)::value, decltype(k)::value>(
        inst, tile_start, tile_nblk, locs, out, tile_walked, store_prefix, num_tiles, tiles_x,
        tile_size, height, block, ln_cutoff, use_cutoff, early_stop_eps, md, s);
  });
}
