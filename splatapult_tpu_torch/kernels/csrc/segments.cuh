// How a tile's chain of blocks is cut for the composite kernels: segments of
// kSegBlocks blocks. The forward stores a checkpoint (colour so far, T) per
// pixel at the first block of every segment; the backward gives every
// segment its own CTA, started from that checkpoint. A compile-time constant,
// the same in both kernels; the wrappers pass the value they sized the
// checkpoint buffer with and the launchers refuse any other. Segments of 4,
// 8 and 16 blocks measured within 2 % of each other in the backward on an
// H100 (garden 1.5M splats, 1920x1080, 128-row blocks, tiles of 9.2 blocks
// on average and up to 147); 8 keeps that view's checkpoints at 79 MB.
//
// Numbering without a table. Tile t owns the blocks [tile_start[t],
// tile_start[t] + nblk[t]) of the instance buffer, and its segment j is
// number first_segment(tile_start[t], t) + j. Consecutive tiles' first
// numbers differ by at least ceil(nblk[t] / kSegBlocks), so no two segments
// share a number, and the last number stays below num_blocks / kSegBlocks +
// num_tiles: the static size of the checkpoint buffer and of the backward's
// grid. A number that belongs to no segment (the numbering has gaps) maps
// back to a tile whose chain ends before it, and its CTA exits.
#pragma once

constexpr int kSegBlocks = 8;
static_assert(kSegBlocks > 0, "a segment holds at least one block");

// (kSeg: segments of another length, for the ablation microbenchmark's
// longer segments only; see composite_fwd.cuh)
template <int kSeg = kSegBlocks>
__device__ __forceinline__ int first_segment(int tile_start_t, int t) {
  return tile_start_t / kSeg + t;
}
