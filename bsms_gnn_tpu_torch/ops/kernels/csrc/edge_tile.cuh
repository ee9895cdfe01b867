// The per-tile fronts of the edge-phase chunk walks. Kernels 4, 5 and 13
// (see ../fused_gmp.py and ../fused_gmp_dyn.py): each slot's sender row,
// receiver and local output row, the tile's fiber stream, and the first edge
// layer's activation relu(fiber·wf8 + xwi[send] + xj[recv]), plus, for
// kernel 13, the dynamic world-space term Δ·wf_dyn + ‖Δ‖·wf_nrm. Kernels 11
// and 12 (see ../fused_gmp_stream.py): the first layer's pre-activation is
// streamed from device memory, plus, for kernel 12, the receiver's row.
#pragma once

#include "common.cuh"

namespace bsms {

// Widest dynamic (world-space) stream kernel 13 takes.
constexpr int MAX_WD = 4;

// The first-layer front of a chunk walk: windowed selection and the fiber
// stream (kernels 4, 5), that plus the world-space fiber (kernel 13), or the
// streamed pre-activation (kernels 11, 12).
enum class Front { kWin, kDyn, kStream };

// Shared-memory tables of one tile's slots.
struct EdgeSlots {
  int* row;    // sender row, -1 = out of window (selects nothing)
  int* recv;   // receiver row
  int* loc;    // local output row, -1 = masked from the scatter
  float* fib;  // [8][TILE] fiber stream (rounded in BF16 mode)
};

// Kernel 13's dynamic fiber: the world positions [n_pad][wd] (the
// activations' type), the Δworld rows of the first edge layer [wd][C]
// (rounded in BF16 mode) and its ‖Δworld‖ row [C] (f32: the TPU kernel
// multiplies it in f32) in shared memory, and the tile's Δ = world[send] −
// world[recv] [wd][TILE] (rounded in BF16 mode, as the dot operand) and
// ‖Δ‖ [TILE] (f32) that edge_tile_pre fills in shared memory.
template <typename T>
struct DynFiber {
  const T* pos;
  int wd;
  const float* wfd;
  const float* wfn;
  float* delta;
  float* nrm;
};

// Fills `s` for the TILE slots from t0 and writes the first layer's
// activation into `tile` (rounded in BF16 mode, as the next dot operand).
// `wf` is the [8][C] fiber weight in shared memory. With DYN, also fills
// dyn.delta and dyn.nrm and adds the dynamic term. Starts with a block
// barrier, so the caller may still be reading the previous tile's tables.
template <typename T, bool BF16, bool DYN = false>
__device__ __forceinline__ void edge_tile_pre(
    int t0, int base, int row0, int e_pad, int window,
    const float* __restrict__ fiber_t, const T* __restrict__ xwi,
    const T* __restrict__ xj, const int* __restrict__ send_win,
    const int* __restrict__ receivers, const float* wf, EdgeSlots s,
    float* tile, DynFiber<T> dyn = {}) {
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
    if constexpr (DYN) {
      // Δ in f32 from the positions as stored (bf16 values in BF16 mode);
      // an out-of-window slot selects no sender (masked downstream).
      float d2 = 0.f;
      for (int k = 0; k < dyn.wd; ++k) {
        const float ps =
            in_win ? to_f(dyn.pos[(size_t)(base + sw) * dyn.wd + k]) : 0.f;
        const float dv = ps - to_f(dyn.pos[(size_t)r * dyn.wd + k]);
        d2 = fmaf(dv, dv, d2);
        dyn.delta[k * TILE + tid] = BF16 ? round_bf16(dv) : dv;
      }
      dyn.nrm[tid] = sqrtf(d2);
    }
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
    float pre = (f + sel) + zj;
    if constexpr (DYN) {
      float fd = 0.f;
      for (int k = 0; k < dyn.wd; ++k)
        fd = fmaf(dyn.delta[k * TILE + r], dyn.wfd[k * C + c], fd);
      pre = (pre + fd) + dyn.nrm[r] * dyn.wfn[c];
    }
    pre = fmaxf(pre, 0.f);
    tile[r * C + c] = BF16 ? round_bf16(pre) : pre;
  }
}

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

// Copies the first edge layer's weights into shared memory: wf8 [8][C]
// and, with DYN, wf_dyn [wd][C] (both rounded in BF16 mode, as dot
// operands) and wf_nrm [C] (f32).
template <bool BF16, bool DYN>
__device__ __forceinline__ void load_first_layer(
    const float* __restrict__ wf8, const float* __restrict__ wfd_g,
    const float* __restrict__ wfn_g, int wd, float* wf, float* wfd,
    float* wfn) {
  const int tid = threadIdx.x;
  for (int i = tid; i < 8 * C; i += THREADS)
    wf[i] = BF16 ? round_bf16(wf8[i]) : wf8[i];
  if constexpr (DYN) {
    for (int i = tid; i < wd * C; i += THREADS)
      wfd[i] = BF16 ? round_bf16(wfd_g[i]) : wfd_g[i];
    for (int i = tid; i < C; i += THREADS) wfn[i] = wfn_g[i];
  }
}

}  // namespace bsms
