// The forward edge walk of kernels 4 (fused_gmp.cu), 11 and 12
// (fused_gmp_stream.cu), 13 (fused_gmp_dyn.cu) and 14 (fused_gmp_k.cu),
// replacing the TPU kernels `bsms_gnn_tpu/ops/pallas/fused_gmp.py:568`
// (`_get_fwd3`, front kWin), `:230` (`_get_fwd`, front kStream: the
// streamed pre-activation), `:376` (`_get_fwd2`, front kStream with the
// receiver row xj[recv_e] added), `:664` (`_get_fwd4`, front kDyn: kWin
// plus the world-space terms) and `:1369` (`_get_fwd5`, front kWin). Per
// live slot e it computes the message msg[e] = LN(tail(relu(pre_e))) with
//   kWin:    pre_e = fiber_t[:, e]ᵀ·wf8 + xwi[send_e] + xj[recv_e]
//   kDyn:    that + Δ_e·wf_dyn + ‖Δ_e‖·wf_nrm, Δ_e = pos[send_e] − pos[recv_e]
//            in f32 from the positions as stored
//   kStream: pre_e = src[e] (+ xj[recv_e] for kernel 12)
// and kernel 4's rounding points (rounded to bf16 in BF16 mode, where the
// TPU kernel rounds it before its f32 sum; with kDyn Δ and wf_dyn rounded
// as dot operands, ‖Δ‖·wf_nrm in f32), and stores it. A slot is live where
// its receiver lies in its chunk's 128-row block (and, windowed, its sender
// in the window): the slots the TPU kernels' one-hot counts, the last
// block's pad slots on row n_pad − 1 included. The aggregate is summed from
// msg by the receiver gather of row_gather.cuh (`recv_gather_kernel` over
// `win_row_*`, or `row_*` for kStream, which list exactly these slots).
//
// What bounds it: operations, in true f32 on the CUDA cores (no TF32): per
// live slot about 2·L·128² FLOP of products, against a few hundred bytes.
//
// What the design does about it, with the grid plan of the backward walk
// (edge_bwd_tiles.cuh), whose helpers it shares:
// - A persistent grid over the level's T = E_pad / TR tiles, not chunks: G
//   blocks (SMs × the blocks per SM the kernel reaches, at most T); each
//   tile finds its chunk, output block and window from its first slot.
//   Block b walks tiles b, b + G, b + 2G, ...: the card places block b on
//   SM b mod SMs, so the blocks of one SM hold ⌊T/SMs⌋ or ⌈T/SMs⌉ tiles
//   together, where tile ranges [⌊b·T/G⌋, ⌊(b+1)·T/G⌋) can give an SM one
//   more (272 tiles on 264 blocks, kernels 4's and 14's level 3: 4 tiles
//   on four SMs, 3 a stride). A message does not depend on the block that
//   computes it.
// - A dead tile (no live slot) skips the front and the GEMMs and writes
//   nothing: no msg row of it is listed.
// - The tail runs in place in one TR×C tile (each warp reads and writes
//   only its own rows), the weights' KS-row slabs double-buffered with
//   cp.async, each GEMM's last slab issuing the next GEMM's first (after
//   the last layer: layer 0's, for the next live tile). In BF16 mode W
//   comes already rounded to bf16 (stored as f32), so the copy rounds
//   nothing.
// - Each output's k-sum is one fmaf chain in k order from zero (the walks'
//   `gemm_rows`: 256 threads, 8 rows × 4 columns a thread, 64-row slabs),
//   the bias added after, so a message row is the same bits whatever the
//   tile shape.
// - No shared-memory output block, no per-chunk part and no chunk sum: the
//   messages' sum is the gather's, in list order, with no atomics, so two
//   calls agree bit for bit.
// - A batch of B samples over the one level (the batch axis of a shared
//   mesh: xwi, xj [B][n_pad][C], msg [B][E_pad][C]) walks B·T tiles in the
//   same stride order, tile t being tile t mod T of sample ⌊t / T⌋: the
//   grid stays the card's fill, and a sample's messages are the bits of a
//   call on that sample alone. Kernel 4 takes it; the other fronts' entries
//   pass B = 1.
// - One TR×C tile and two slabs take about 97 KB of shared memory (kWin 6
//   KB more: the fiber weights and stream; kDyn 3.75 KB more again: wf_dyn,
//   wf_nrm, the tile's Δ and ‖Δ‖), so two blocks fit on an SM: one block's
//   loads of the front overlap the other's products.
#pragma once

#include "edge_bwd_tiles.cuh"

namespace bsms {
namespace tiles {

constexpr int FWD_MIN_BLOCKS = 2;

// Shared memory of the forward walk: the tile, two weight slabs, with kWin
// and kDyn the fiber weights and stream, with kDyn also wf_dyn, wf_nrm and
// the tile's Δ and ‖Δ‖, then the three int tables of the tile's slots.
constexpr size_t fwd_smem_bytes(Front f) {
  return sizeof(float) * ((size_t)TR * C + 2 * KS * C +
                          (f != Front::kStream ? 8 * C + 8 * TR : 0) +
                          (f == Front::kDyn
                               ? MAX_WD * C + C + MAX_WD * TR + TR : 0)) +
         sizeof(int) * 3 * TR;
}

// Stores 4 columns of a message row (bf16 in BF16 mode: the LN output
// rounded to nearest even, as the TPU kernel rounds it).
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&a);
  u.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// The walk. kWin: xwi, xj, fiber_t, wf8, send_win, win_base as kernel 4's;
// kDyn (kernel 13): those plus the positions pos [n_pad][wd] (xwi's type),
// wf_dyn [wd][C] and wf_nrm [C]; kStream (kernels 11 and 12): xwi the
// streamed rows src [E_pad][C] (pre, or zi with the receiver transform xj;
// xj null for kernel 11), no fiber, window or positions. W the tail's stack
// (bf16 values in BF16 mode), B its biases; msg [E_pad][C] in the
// activations' type, written on live slots only. With n_batch samples
// (kWin), sample s's xwi and xj start s·x_stride elements in, its msg
// s·e_stride.
template <typename T, bool BF16, Front F>
__device__ __forceinline__ void edge_fwd_tiles(
    const float* __restrict__ fiber_t, const T* __restrict__ xwi,
    const T* __restrict__ xj, const float* __restrict__ wf8,
    const float* __restrict__ W, const float* __restrict__ B, int n_layers,
    const int* __restrict__ send_win, const int* __restrict__ win_base,
    const int* __restrict__ receivers, const int* __restrict__ chunk_block,
    int n_tiles, int e_pad, int edge_block, int window, T* __restrict__ msg,
    const T* __restrict__ pos = nullptr,
    const float* __restrict__ wfd_g = nullptr,
    const float* __restrict__ wfn_g = nullptr, int wd = 0, int n_batch = 1,
    size_t x_stride = 0, size_t e_stride = 0) {
  constexpr bool WIN = F != Front::kStream;
  constexpr bool DYN = F == Front::kDyn;
  extern __shared__ float4 smem4[];
  float* h = reinterpret_cast<float*>(smem4);  // [TR][C] the tile's rows
  float* wslab = h + TR * C;                    // [2][KS][C] weight slabs
  float* wf = wslab + 2 * KS * C;               // WIN: [8][C] fiber weights
  float* fib = wf + (WIN ? 8 * C : 0);          // WIN: [8][TR] fiber stream
  float* wfd = fib + (WIN ? 8 * TR : 0);        // DYN: [MAX_WD][C] wf_dyn
  float* wfn = wfd + (DYN ? MAX_WD * C : 0);    // DYN: [C] wf_nrm
  float* delta = wfn + (DYN ? C : 0);           // DYN: [MAX_WD][TR] Δ
  float* nrm = delta + (DYN ? MAX_WD * TR : 0);  // DYN: [TR] ‖Δ‖
  int* s_row = reinterpret_cast<int*>(nrm + (DYN ? TR : 0));
  int* s_recv = s_row + TR;
  int* s_loc = s_recv + TR;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x, b = blockIdx.x;
  if constexpr (WIN)  // the fiber weights, rounded in BF16 mode
    for (int i = tid; i < 8 * C; i += NT) wf[i] = BF16 ? round_bf16(wf8[i]) : wf8[i];
  if constexpr (DYN) {  // wf_dyn rounded in BF16 mode, wf_nrm in f32
    for (int i = tid; i < wd * C; i += NT)
      wfd[i] = BF16 ? round_bf16(wfd_g[i]) : wfd_g[i];
    for (int i = tid; i < C; i += NT) wfn[i] = wfn_g[i];
  }
  const DynFiber<T> dyn{pos, wd, wfd, wfn, delta, nrm};
  copy_slab(W, 0, wslab);  // the first GEMM's first slab (see gemm_rows)

  const int total = n_tiles * n_batch;
  for (int t = b; t < total; t += G) {  // see the header
    const int smp = t / n_tiles, t0 = (t - smp * n_tiles) * TR;
    const int ch = t0 / edge_block;
    if (!tile_slots<BF16, F, T>(t0, ch, fiber_t, send_win, win_base,
                                receivers, chunk_block, e_pad, window, s_row,
                                s_recv, s_loc, fib, dyn))
      continue;  // a dead tile: no message of it is listed
    tile_front<T, BF16, F>(t0, xwi + smp * x_stride,
                           xj == nullptr ? xj : xj + smp * x_stride, wf, fib,
                           s_row, s_recv, h, dyn);
    T* msg_s = msg + smp * e_stride;
    for (int l = 0; l < n_layers; ++l) {
      float acc[RW][4] = {};
      gemm_rows(acc, h, W + (size_t)l * C * C,
                W + (l + 1 < n_layers ? (size_t)(l + 1) * C * C : 0), wslab);
      const bool last = l == n_layers - 1;
      store_rows(acc, B + l * C, h, !last, BF16 && !last);
    }
    // The LayerNorm of each of the warp's own rows (gemm_rows' layout, so
    // no barrier), then each live slot's message row.
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = RW * warp + i;
      float4 v = reinterpret_cast<const float4*>(h + r * C)[lane];
      const float mean = warp_sum(v.x + v.y + v.z + v.w) / C;
      v.x -= mean; v.y -= mean; v.z -= mean; v.w -= mean;
      const float var = warp_sum(v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w) / C;
      const float iv = 1.0f / sqrtf(var + LN_EPS);
      v.x *= iv; v.y *= iv; v.z *= iv; v.w *= iv;
      if (s_loc[r] >= 0) store4(msg_s + (size_t)(t0 + r) * C + 4 * lane, v);
    }
  }
  cp_async_wait_all();  // the next tile's first slab, never used
}

// Blocks of one SM the forward walk with front f reaches for `kernel` (the
// launch bounds, registers and shared memory decide), after raising its
// shared-memory limit.
template <typename K>
cudaError_t fwd_blocks_per_sm(K kernel, Front f, int* out) {
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)fwd_smem_bytes(f));
  if (attr != cudaSuccess) return attr;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, NT,
                                                       fwd_smem_bytes(f));
}

}  // namespace tiles
}  // namespace bsms
