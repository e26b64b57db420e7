// probe_scatter: the scatter probes of a radix-sort pass, for sm_90a: the
// kernels of splatapult_tpu_torch/tools/probe_scatter.py.
//
// Replaces the TPU kernels of tools/probe_scatter.py, which ask whether Mosaic
// can express the scatter half of a radix-sort pass. On rows [NB * B, W] f32
// (W a multiple of 4; the tool's 8 is 32 bytes, one DRAM sector), block j of
// B rows:
//   P1  :77   kernel_a  out[j*B + dest[j, i]] = rows[j*B + i]   (a per-row store)
//   P2  :118  kernel_b  out[j*B + cdest[j, c]*CH + r] = rows[j*B + c*CH + r],
//                       r < CH = 128, the tool's chunk           (chunk stores)
//   P3  :161  kernel_c  the output block zeroed, then the same for r < CH/2
//                       only                                     (masked stores)
//
// Contract: each block's table is a permutation (of its B rows; of its
// NCH = B / CH chunks), as the TPU tool draws it, so every output row is
// written exactly once, from inside its own block, and the order of the
// stores does not matter. The wrappers (tools/probe_scatter.py) check it on
// the device before they launch; the kernels trust it.
//
// Bound on an H100: bytes. P1 reads the rows and the table and writes the
// rows; P2 reads and writes the rows (its table is NB * NCH ints); P3 reads
// the half it stores and writes every row. There is no arithmetic to speak
// of.
//
// Design. One thread per 16 bytes of a row (a float4), threads in row order:
// a warp's loads are 512 consecutive bytes. Under P1's permutation the
// threads of one row store its W * 4 bytes together, whole sectors for the
// tool's rows, so the scattered stores cost no extra sector traffic. P2 and P3
// move 4 KiB chunks (CH = 128 rows of 32 bytes): a warp's 512 bytes lie
// inside one chunk at both ends. P3's threads of a chunk's second half read
// nothing and store zeros where that half would have landed: with a
// permutation each destination chunk's second half is written exactly once
// that way, so the zero fill costs no pass of its own.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunkRows = 128;  // CH, fixed as the TPU tool fixes it (:101)

// vec: the float4 of rows [r, q] with r = vec / quads, q = vec % quads
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(const float4* __restrict__ rows, const int* __restrict__ dest,
                    float4* __restrict__ out, int vecs, int block_rows, int quads) {
  const int vec = blockIdx.x * kThreads + threadIdx.x;
  if (vec >= vecs) return;
  const int r = vec / quads;
  const int q = vec - r * quads;
  const int first = r - r % block_rows;  // the block's first row; dest is [NB, B] row-major
  out[(first + __ldg(dest + r)) * quads + q] = __ldg(rows + vec);
}

template <bool kHalf>
__global__ void __launch_bounds__(kThreads)
scatter_chunks_kernel(const float4* __restrict__ rows, const int* __restrict__ cdest,
                      float4* __restrict__ out, int vecs, int block_rows, int quads) {
  const int vec = blockIdx.x * kThreads + threadIdx.x;
  if (vec >= vecs) return;
  const int r = vec / quads;
  const int q = vec - r * quads;
  const int chunk = r / kChunkRows;  // the chunk's number in the whole array: j * NCH + c
  const int in_chunk = r - chunk * kChunkRows;
  const int chunks = block_rows / kChunkRows;
  const int first = chunk - chunk % chunks;  // the block's first chunk
  float4* dst = out + ((first + __ldg(cdest + chunk)) * kChunkRows + in_chunk) * quads + q;
  if (kHalf && in_chunk >= kChunkRows / 2) {
    *dst = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else {
    *dst = __ldg(rows + vec);
  }
}

bool bad_shape(int blocks, int block_rows, int quads) {
  // every index fits an int: the wrapper takes at most 2^31 - 1 floats
  return blocks < 0 || block_rows <= 0 || quads <= 0 ||
         static_cast<long long>(blocks) * block_rows * quads * 4 > 0x7fffffffLL;
}

int grid_of(int vecs) { return (vecs + kThreads - 1) / kThreads; }

template <bool kHalf>
int launch_chunks(const void* rows, const void* cdest, void* out, int blocks, int block_rows,
                  int quads, void* stream) {
  if (bad_shape(blocks, block_rows, quads) || block_rows % kChunkRows != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vecs = blocks * block_rows * quads;
  if (vecs == 0) return 0;
  scatter_chunks_kernel<kHalf><<<grid_of(vecs), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(rows), static_cast<const int*>(cdest), static_cast<float4*>(out),
      vecs, block_rows, quads);
  return static_cast<int>(cudaGetLastError());
}

// Does nothing: one launch of it, timed in the probes' rounds, is their
// launch floor (tools/probe_scatter.py, launch_floor_calls).
__global__ void empty_kernel() {}

}  // namespace

// P1. rows, out [blocks * block_rows, 4 * quads] f32 (16-byte aligned);
// dest [blocks, block_rows] int32, each row a permutation of 0..block_rows-1.
extern "C" int splat_probe_scatter_rows(const void* rows, const void* dest, void* out,
                                        int blocks, int block_rows, int quads, void* stream) {
  if (bad_shape(blocks, block_rows, quads)) return static_cast<int>(cudaErrorInvalidValue);
  const int vecs = blocks * block_rows * quads;
  if (vecs == 0) return 0;
  scatter_rows_kernel<<<grid_of(vecs), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(rows), static_cast<const int*>(dest), static_cast<float4*>(out),
      vecs, block_rows, quads);
  return static_cast<int>(cudaGetLastError());
}

// P2. cdest [blocks, block_rows / 128] int32, each row a permutation;
// block_rows a multiple of 128.
extern "C" int splat_probe_scatter_chunks(const void* rows, const void* cdest, void* out,
                                          int blocks, int block_rows, int quads, void* stream) {
  return launch_chunks<false>(rows, cdest, out, blocks, block_rows, quads, stream);
}

// P3. As P2, the first 64 rows of each chunk stored, the rest of the
// output zero.
extern "C" int splat_probe_scatter_half_chunks(const void* rows, const void* cdest, void* out,
                                               int blocks, int block_rows, int quads,
                                               void* stream) {
  return launch_chunks<true>(rows, cdest, out, blocks, block_rows, quads, stream);
}

// An empty kernel, one thread: the least a launch costs.
extern "C" int splat_probe_empty(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
