// The per-tile front of kernels 4 and 5 (see ../fused_gmp.py): each slot's
// sender row, receiver and local output row, the tile's fiber stream, and
// the first edge layer's activation relu(fiber·wf8 + xwi[send] + xj[recv]).
#pragma once

#include "common.cuh"

namespace bsms {

// Shared-memory tables of one tile's slots.
struct EdgeSlots {
  int* row;    // sender row, -1 = out of window (selects nothing)
  int* recv;   // receiver row
  int* loc;    // local output row, -1 = masked from the scatter
  float* fib;  // [8][TILE] fiber stream (rounded in BF16 mode)
};

// Fills `s` for the TILE slots from t0 and writes the first layer's
// activation into `tile` (rounded in BF16 mode, as the next dot operand).
// `wf` is the [8][C] fiber weight in shared memory. Starts with a block
// barrier, so the caller may still be reading the previous tile's tables.
template <typename T, bool BF16>
__device__ __forceinline__ void edge_tile_pre(
    int t0, int base, int row0, int e_pad, int window,
    const float* __restrict__ fiber_t, const T* __restrict__ xwi,
    const T* __restrict__ xj, const int* __restrict__ send_win,
    const int* __restrict__ receivers, const float* wf, EdgeSlots s,
    float* tile) {
  const int tid = threadIdx.x;
  __syncthreads();
  if (tid < TILE) {
    const int e = t0 + tid;
    const int sw = send_win[e], r = receivers[e];
    const int loc = r - row0;
    const bool in_win = sw < window;
    s.row[tid] = in_win ? base + sw : -1;
    s.recv[tid] = r;
    s.loc[tid] = (in_win && loc >= 0 && loc < BN) ? loc : -1;
  }
  for (int i = tid; i < 8 * TILE; i += THREADS) {
    const float f = fiber_t[(size_t)(i / TILE) * e_pad + t0 + i % TILE];
    s.fib[i] = BF16 ? round_bf16(f) : f;
  }
  __syncthreads();
  const int c = tid & (C - 1);
  const int half = tid >> 7;
  for (int r = half; r < TILE; r += 2) {
    float f = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) f = fmaf(s.fib[k * TILE + r], wf[k * C + c], f);
    const int row = s.row[r];
    const float sel = row >= 0 ? to_f(xwi[(size_t)row * C + c]) : 0.f;
    const float zj = to_f(xj[(size_t)s.recv[r] * C + c]);
    const float pre = fmaxf((f + sel) + zj, 0.f);
    tile[r * C + c] = BF16 ? round_bf16(pre) : pre;
  }
}

}  // namespace bsms
