// The forward chunk walk of kernels 4 and 13 (see ../fused_gmp.py and
// ../fused_gmp_dyn.py): one block per edge chunk walks the chunk in 64-slot
// tiles and adds each tile into a shared-memory copy of the chunk's 128-row
// output block, one thread per (column, half-block), in slot order; the
// block is written to part[chunk]. block_sum_kernel then adds the parts of
// each output block in chunk order. DYN adds kernel 13's world-space fiber.
#pragma once

#include "edge_tile.cuh"

namespace bsms {

// Dynamic shared memory of the walk: floats, then three int tables.
template <bool DYN>
constexpr size_t edge_fwd_smem_bytes() {
  return sizeof(float) * (BN * C + TILE * C + KS * C + 8 * C + 8 * TILE +
                          (DYN ? MAX_WD * C + C + MAX_WD * TILE + TILE : 0)) +
         sizeof(int) * 3 * TILE;
}

template <typename T, bool BF16, bool DYN>
__device__ __forceinline__ void edge_phase_fwd_chunk(
    const float* __restrict__ fiber_t, const T* __restrict__ xwi,
    const T* __restrict__ xj, const T* __restrict__ pos,
    const float* __restrict__ wf8, const float* __restrict__ wfd_g,
    const float* __restrict__ wfn_g, int wd, const float* __restrict__ W,
    const float* __restrict__ B, int n_layers,
    const int* __restrict__ send_win, const int* __restrict__ win_base,
    const int* __restrict__ receivers, const int* __restrict__ chunk_block,
    int e_pad, int edge_block, int window, float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);  // [BN][C] output block
  float* tile = acc + BN * C;                     // [TILE][C] edge rows
  float* wslab = tile + TILE * C;                 // [KS][C] staged weights
  float* wf = wslab + KS * C;                     // [8][C] fiber weights
  float* fib = wf + 8 * C;                        // [8][TILE] fiber stream
  float* wfd = fib + 8 * TILE;                    // DYN: [MAX_WD][C] Δ rows
  float* wfn = wfd + (DYN ? MAX_WD * C : 0);      // DYN: [C] ‖Δ‖ row
  float* delta = wfn + (DYN ? C : 0);             // DYN: [MAX_WD][TILE]
  float* nrm = delta + (DYN ? MAX_WD * TILE : 0);  // DYN: [TILE]
  int* s_row = reinterpret_cast<int*>(nrm + (DYN ? TILE : 0));  // sender row
  int* s_recv = s_row + TILE;                                   // receiver
  int* s_loc = s_recv + TILE;  // local output row, -1 = masked from scatter

  const int tid = threadIdx.x, ch = blockIdx.x;
  const int base = win_base[ch] * (window / 2);
  const int row0 = chunk_block[ch] * BN;
  for (int i = tid; i < BN * C; i += THREADS) acc[i] = 0.f;
  load_first_layer<BF16, DYN>(wf8, wfd_g, wfn_g, wd, wf, wfd, wfn);

  const int c = tid & (C - 1);  // column of the scatter step
  const int half = tid >> 7;    // which half of the rows this thread takes
  const EdgeSlots slots{s_row, s_recv, s_loc, fib};
  const DynFiber<T> dyn{pos, wd, wfd, wfn, delta, nrm};
  for (int t0 = ch * edge_block; t0 < (ch + 1) * edge_block; t0 += TILE) {
    // Starts with a barrier: the previous tile's scatter is done.
    edge_tile_pre<T, BF16, DYN>(t0, base, row0, e_pad, window, fiber_t, xwi,
                                xj, send_win, receivers, wf, slots, tile, dyn);
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
