// composite_bwd_ablate: the composite backward (composite_bwd.cu) with one
// piece taken out at a time, for sm_90a: the kernels of the ablation
// microbenchmark splatapult_tpu_torch/tools/microbench_bwdk.py.
//
// Replaces the TPU kernel of tools/microbench_bwdk.py: the pallas_call at
// :210 (make_kernel(variant), the block body of ops/composite.py::_bwd_kernel
// with one piece removed: full, nowork, noscan, noscan2, nomom, tri_bf16;
// vpu_cdot, vpu_carry and vpu_all compute full's function on the TPU's
// vector unit instead of its matrix unit, and a GPU has one unit for both,
// so the tool launches kBwdFull for them). Each variant is composite_bwd.cuh's
// body instantiated with a variant (see that header for what each removes)
// for the f32x16 rows and f32 output rows, the layout the TPU tool ablates.
// kBwdFull is the shipped code compiled a second time, so the tool can hold
// it against the shipped kernel bit for bit and in time. The variants'
// instantiations live in this translation unit alone, so composite_bwd.cu's
// are the ones it always had.
//
// Bound: each variant does at most the shipped kernel's work, so the tool
// states the shipped function's bound (tools/profile_phases.composite_bounds)
// beside them.

#include <type_traits>

#include "composite_bwd.cuh"

namespace {

template <int V>
using Variant = std::integral_constant<int, V>;

// launch(Variant<v>) for the runtime variant v
template <typename Launch>
int by_variant(int variant, Launch&& launch) {
  switch (variant) {
    case kBwdFull: return launch(Variant<kBwdFull>{});
    case kBwdNoWork: return launch(Variant<kBwdNoWork>{});
    case kBwdNoScan: return launch(Variant<kBwdNoScan>{});
    case kBwdNoScan2: return launch(Variant<kBwdNoScan2>{});
    case kBwdNoMom: return launch(Variant<kBwdNoMom>{});
    case kBwdTriBf16: return launch(Variant<kBwdTriBf16>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int splat_ablate_bwd(int variant, const void* inst, const void* tile_start,
                                const void* tile_walked, const void* ckpt, const void* out_res,
                                const void* dout, void* d_inst, int num_segments, int num_tiles,
                                int mcap, int tiles_x, int tile_size, int height, int block,
                                float ln_cutoff, int use_cutoff, void* stream) {
  if (num_tiles <= 0 || num_segments <= 0) return 0;
  // the variants find a block's end by 32-row sub-chunk
  if (tile_size * tile_size > kMaxThreads || block <= 0 || block % kChunkRows != 0 ||
      mcap <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const MeanDecode md{0.0f, 0.0f, 0.0f, 0.0f};  // f32x16 rows decode no mean
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_variant(variant, [&](auto v) {
    return launch_bwd<kRowF32x16, float, decltype(v)::value>(
        inst, tile_start, tile_walked, ckpt, out_res, dout, d_inst, num_segments, num_tiles,
        mcap, tiles_x, tile_size, height, block, ln_cutoff, use_cutoff, md, s);
  });
}
