// The forward chunk walk of kernels 11 and 12 (see ../fused_gmp_stream.py):
// one block per edge chunk walks the chunk in 64-slot tiles of the streamed
// first-layer input (`src`: the whole pre-activation for kernel 11, the
// sender half zi for kernel 12, whose receiver rows xj are added where the
// receiver lies in the chunk's block) and adds each tile into a
// shared-memory copy of the chunk's 128-row output block, one thread per
// (column, half-block), in slot order; the block is written to part[chunk].
// block_sum_kernel then adds the parts of each output block in chunk order.
// Kernels 4, 13 and 14 run the forward tile walk of edge_fwd_tiles.cuh
// instead.
#pragma once

#include "edge_tile.cuh"

namespace bsms {

// Dynamic shared memory of the walk: the output block, the tile and one
// weight slab, then two int tables.
constexpr size_t edge_fwd_smem_bytes() {
  return sizeof(float) * (BN * C + TILE * C + KS * C) +
         sizeof(int) * 2 * TILE;
}

template <typename T, bool BF16>
__device__ __forceinline__ void edge_phase_fwd_chunk(
    const T* __restrict__ src, const T* __restrict__ xj,
    const float* __restrict__ W, const float* __restrict__ B, int n_layers,
    const int* __restrict__ receivers, const int* __restrict__ chunk_block,
    int edge_block, float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);  // [BN][C] output block
  float* tile = acc + BN * C;                     // [TILE][C] edge rows
  float* wslab = tile + TILE * C;                 // [KS][C] staged weights
  int* s_recv = reinterpret_cast<int*>(wslab + KS * C);  // receiver
  int* s_loc = s_recv + TILE;  // local output row, -1 = masked from scatter

  const int tid = threadIdx.x, ch = blockIdx.x;
  const int row0 = chunk_block[ch] * BN;
  for (int i = tid; i < BN * C; i += THREADS) acc[i] = 0.f;

  const int c = tid & (C - 1);  // column of the scatter step
  const int half = tid >> 7;    // which half of the rows this thread takes
  const EdgeSlots slots{s_recv, s_loc};
  for (int t0 = ch * edge_block; t0 < (ch + 1) * edge_block; t0 += TILE) {
    // Starts with a barrier: the previous tile's scatter is done.
    stream_tile_pre<T, BF16>(t0, row0, src, xj, receivers, slots, tile);
    tile_mlp_tail<BF16>(tile, W, B, n_layers, wslab);
    for (int r = 0; r < TILE; ++r) {
      const int loc = s_loc[r];
      if (loc >= 0 && (loc >> 6) == half) {
        const float v = tile[r * C + c];
        acc[loc * C + c] += BF16 ? round_bf16(v) : v;
      }
    }
  }
  __syncthreads();
  float4* dst = reinterpret_cast<float4*>(part + (size_t)ch * BN * C);
  for (int i = tid; i < BN * C / 4; i += THREADS) dst[i] = smem4[i];
}

}  // namespace bsms
