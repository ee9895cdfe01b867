// The edge phase's first-layer fronts. The windowed fronts of the tile
// walks (edge_bwd_tiles.cuh's `tile_slots` and `tile_front`): kWin (kernels
// 4, 5 and 14, see ../fused_gmp.py and ../fused_gmp_k.py), each slot's
// sender row, receiver and fiber stream and relu(fiber·wf8 + xwi[send] +
// xj[recv]); kDyn (kernel 13, see ../fused_gmp_dyn.py), that plus the
// dynamic world-space term Δ·wf_dyn + ‖Δ‖·wf_nrm. The streamed front
// (kStream, kernels 11 and 12, see ../fused_gmp_stream.py): the first
// layer's pre-activation streamed from device memory, plus, for kernel 12,
// the receiver's row; here `stream_tile_pre`, that of the forward chunk
// walk (edge_phase.cuh).
#pragma once

#include "common.cuh"

namespace bsms {

// Widest dynamic (world-space) stream kernel 13 takes.
constexpr int MAX_WD = 4;

// The first-layer front of an edge walk: windowed selection and the fiber
// stream (kernels 4, 5, 14), that plus the world-space fiber (kernel 13),
// or the streamed pre-activation (kernels 11, 12).
enum class Front { kWin, kDyn, kStream };

// Shared-memory tables of one tile's slots in the streamed chunk walk.
struct EdgeSlots {
  int* recv;  // receiver row
  int* loc;   // local output row, -1 = masked from the scatter
};

// Kernel 13's dynamic fiber: the world positions [n_pad][wd] (the
// activations' type), the Δworld rows of the first edge layer [wd][C]
// (rounded in BF16 mode) and its ‖Δworld‖ row [C] (f32: the TPU kernel
// multiplies it in f32) in shared memory, and the tile's Δ = world[send] −
// world[recv] [wd][TR] (rounded in BF16 mode, as the dot operand) and
// ‖Δ‖ [TR] (f32) that the tile walks' `tile_slots` fills in shared memory.
template <typename T>
struct DynFiber {
  const T* pos;
  int wd;
  const float* wfd;
  const float* wfn;
  float* delta;
  float* nrm;
};

// The streamed front: fills s.recv and s.loc for the TILE slots from t0
// (s.loc = -1 where the receiver lies outside the chunk's 128-row output
// block: the TPU kernels' one-hot gives such a slot nothing, so it adds
// nothing to the aggregate and gets no cotangent) and writes
// relu(src[e] + xj[recv_e]) into `tile` (rounded in BF16 mode, as the next
// dot operand). xj null (kernel 11): src is the whole pre-activation; a slot
// outside the block takes no receiver row. Starts with a block barrier.
template <typename T, bool BF16>
__device__ __forceinline__ void stream_tile_pre(
    int t0, int row0, const T* __restrict__ src, const T* __restrict__ xj,
    const int* __restrict__ receivers, EdgeSlots s, float* tile) {
  const int tid = threadIdx.x;
  __syncthreads();
  if (tid < TILE) {
    const int r = receivers[t0 + tid];
    const int loc = r - row0;
    s.recv[tid] = r;
    s.loc[tid] = (loc >= 0 && loc < BN) ? loc : -1;
  }
  __syncthreads();
  const int c = tid & (C - 1);
  const int half = tid >> 7;
  for (int r = half; r < TILE; r += 2) {
    float pre = to_f(src[(size_t)(t0 + r) * C + c]);
    if (xj != nullptr && s.loc[r] >= 0)
      pre += to_f(xj[(size_t)s.recv[r] * C + c]);
    pre = fmaxf(pre, 0.f);
    tile[r * C + c] = BF16 ? round_bf16(pre) : pre;
  }
}

}  // namespace bsms
