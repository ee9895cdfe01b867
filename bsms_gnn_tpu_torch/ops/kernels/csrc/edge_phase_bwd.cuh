// The backward chunk walk of kernels 5, 11, 12 and 13 (see ../fused_gmp.py,
// ../fused_gmp_stream.py and ../fused_gmp_dyn.py), with the forward
// recomputed in the kernel. The front F is the forward walk's
// (edge_phase.cuh).
//
// For the aggregate's cotangent g, each unmasked slot e gets the edge
// cotangent g[recv_e] (zero on masked slots), runs the LayerNorm backward
// and the tail layers in reverse, and yields
//   dpre[e]  the cotangent of its first-layer pre-activation,
//   dxj[n]   = Σ_{e: recv(e)=n} dpre[e] (skipped when `part` is null:
//            kernel 11 has no receiver rows),
//   dwf8     = fiber_t · dpre (not with kStream),  dW[l], db[l]  the tail's
//            weight gradients,
// and with kDyn (kernel 13)
//   dwf_dyn  = Δᵀ · dpre (bf16 operands in BF16 mode),
//   dwf_nrm  = Σ_e ‖Δ_e‖ · dpre[e] (f32, dpre before its bf16 rounding).
//
// One block per edge chunk walks it in 64-slot tiles, keeping every tail
// layer's input, the running cotangent and the chunk's 128-row dxj block in
// shared memory (kernel 14's backward names its block's chunk, `chunk`, and
// keeps the dxj block in shared memory, `store_part` false, for its cluster
// to sum). dxj takes kernel 4's scheme (a part per chunk, summed over
// chunk_ptr by block_sum_kernel). The weight gradients: each chunk adds its
// tiles into its own partial in device memory, in tile order, and
// grad_sum_kernel adds the partials in chunk order (no atomics). A chunk's
// partial is [dW | db | dwf8 | dwf_dyn | dwf_nrm] (dwf8 not with kStream,
// the last two with kDyn).
#pragma once

#include "backward.cuh"
#include "edge_tile.cuh"

namespace bsms {

constexpr int MAX_BWD_LAYERS = 3;

template <bool DYN>
size_t edge_bwd_smem_bytes(int n_layers) {
  return sizeof(float) *
             (BN * C + (size_t)(n_layers + 1) * TILE * C + KS * C + 8 * C +
              8 * TILE + TILE +
              (DYN ? MAX_WD * C + C + MAX_WD * TILE + TILE : 0)) +
         sizeof(int) * 3 * TILE;
}

// Floats of one chunk's weight-gradient partial.
template <Front F>
__host__ __device__ inline int edge_grad_size(int n_layers, int wd) {
  return n_layers * C * C + n_layers * C +
         (F == Front::kStream ? 0 : 8 * C) +
         (F == Front::kDyn ? wd * C + C : 0);
}

template <typename T, bool BF16, Front F>
__device__ __forceinline__ void edge_phase_bwd_chunk(
    const float* __restrict__ fiber_t, const T* __restrict__ xwi,
    const T* __restrict__ xj, const T* __restrict__ pos,
    const float* __restrict__ wf8, const float* __restrict__ wfd_g,
    const float* __restrict__ wfn_g, int wd, const float* __restrict__ W,
    const float* __restrict__ B, const float* __restrict__ WT,
    const float* __restrict__ g, int n_layers,
    const int* __restrict__ send_win, const int* __restrict__ win_base,
    const int* __restrict__ receivers, const int* __restrict__ chunk_block,
    int e_pad, int edge_block, int window, float* __restrict__ part,
    float* __restrict__ gpart, T* __restrict__ dpre, int chunk = -1,
    bool store_part = true) {
  constexpr bool DYN = F == Front::kDyn;
  constexpr bool STREAM = F == Front::kStream;
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);  // [BN][C] dxj block
  float* hs = acc + BN * C;         // [n_layers][TILE][C] tail layer inputs
  float* d = hs + (size_t)n_layers * TILE * C;  // [TILE][C] LN out, cotangent
  float* wslab = d + TILE * C;                  // [KS][C] staged weights
  float* wf = wslab + KS * C;                   // [8][C] fiber weights
  float* fib = wf + 8 * C;                      // [8][TILE] fiber stream
  float* inv = fib + 8 * TILE;                  // [TILE] LN 1/std
  float* wfd = inv + TILE;                      // DYN: [MAX_WD][C] Δ rows
  float* wfn = wfd + (DYN ? MAX_WD * C : 0);    // DYN: [C] ‖Δ‖ row
  float* delta = wfn + (DYN ? C : 0);           // DYN: [MAX_WD][TILE]
  float* nrm = delta + (DYN ? MAX_WD * TILE : 0);  // DYN: [TILE]
  int* s_row = reinterpret_cast<int*>(nrm + (DYN ? TILE : 0));
  int* s_recv = s_row + TILE;
  int* s_loc = s_recv + TILE;

  const int tid = threadIdx.x, ch = chunk < 0 ? blockIdx.x : chunk;
  const int lane = tid & 31, warp = tid >> 5;
  const int base = STREAM ? 0 : win_base[ch] * (window / 2);
  const int row0 = chunk_block[ch] * BN;
  const size_t wsize = (size_t)n_layers * C * C;
  const bool with_dxj = part != nullptr;
  float* gp = gpart + (size_t)ch * edge_grad_size<F>(n_layers, wd);
  float* gp_b = gp + wsize;                   // db [n_layers][C]
  float* gp_f = gp_b + (size_t)n_layers * C;  // dwf8 [8][C]
  float* gp_d = gp_f + 8 * C;                 // DYN: dwf_dyn [wd][C]
  float* gp_n = gp_d + (DYN ? wd * C : 0);    // DYN: dwf_nrm [C]
  if (with_dxj)
    for (int i = tid; i < BN * C; i += THREADS) acc[i] = 0.f;
  if constexpr (!STREAM)
    load_first_layer<BF16, DYN>(wf8, wfd_g, wfn_g, wd, wf, wfd, wfn);

  const int c = tid & (C - 1);
  const int half = tid >> 7;
  const EdgeSlots slots{s_row, s_recv, s_loc, fib};
  const DynFiber<T> dyn{pos, wd, wfd, wfn, delta, nrm};
  for (int t0 = ch * edge_block; t0 < (ch + 1) * edge_block; t0 += TILE) {
    const bool add = t0 != ch * edge_block;  // the chunk's first tile stores
    // Recompute: relu(pre) into hs[0], the tail keeping each layer's input,
    // the LayerNorm output into d.
    if constexpr (STREAM)
      stream_tile_pre<T, BF16>(t0, row0, xwi, xj, receivers, slots, hs);
    else
      edge_tile_pre<T, BF16, DYN>(t0, base, row0, e_pad, window, fiber_t,
                                  xwi, xj, send_win, receivers, wf, slots, hs,
                                  dyn);
    tile_mlp_tail_save<BF16>(hs, d, inv, W, B, n_layers, wslab);

    // Edge cotangent g[recv] (rounded to bf16 by the TPU kernel's one-hot
    // dot in BF16 mode; zero on masked slots), then the LN backward.
    for (int r = warp; r < TILE; r += THREADS / 32) {
      float4 gv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s_loc[r] >= 0) {
        gv = reinterpret_cast<const float4*>(g + (size_t)s_recv[r] * C)[lane];
        if (BF16) {
          gv.x = round_bf16(gv.x); gv.y = round_bf16(gv.y);
          gv.z = round_bf16(gv.z); gv.w = round_bf16(gv.w);
        }
      }
      float4* dp = reinterpret_cast<float4*>(d + r * C) + lane;
      *dp = ln_bwd(gv, *dp, inv[r]);
    }

    // Tail layers in reverse: db from the unrounded cotangent, dW and the
    // next cotangent from the rounded one, masked by the layer's input.
    for (int l = n_layers - 1; l >= 0; --l) {
      const float* h = hs + (size_t)l * TILE * C;
      __syncthreads();
      if (tid < C) {
        const float s = tile_colsum(d);
        gp_b[l * C + tid] = add ? gp_b[l * C + tid] + s : s;
      }
      if (BF16) tile_round_bf16(d);
      __syncthreads();
      float dw[8][8] = {};
      tile_gemm_tn(dw, h, d);
      store_tn(dw, gp + (size_t)l * C * C, add);
      float dh[8][4] = {};
      tile_gemm<BF16>(dh, d, WT + (size_t)l * C * C, wslab);
      tile_store_masked(dh, h, d);
    }
    if constexpr (DYN) {
      // dwf_nrm from dpre before any rounding (the TPU kernel's f32 sum).
      __syncthreads();
      if (tid < C) {
        float s = 0.f;
        for (int r = 0; r < TILE; ++r) s = fmaf(nrm[r], d[r * C + tid], s);
        gp_n[tid] = add ? gp_n[tid] + s : s;
      }
    }
    // d is now dpre: stored (bf16 in BF16 mode, which is also the operand
    // of the dxj, dwf8 and dwf_dyn sums), then the fiber-weighted sums of
    // dpre (rows of fiber_t, then with DYN the rows of Δ) and the dxj block.
    if (BF16) tile_round_bf16(d);
    else __syncthreads();
    for (int i = tid; i < TILE * C; i += THREADS)
      store(&dpre[(size_t)t0 * C + i], d[i]);
    const int n_rows = STREAM ? 0 : DYN ? 8 + wd : 8;
    for (int k = warp; k < n_rows; k += THREADS / 32) {
      const int j0 = lane * 4;
      const float* fk = k < 8 ? fib + k * TILE : delta + (k - 8) * TILE;
      float s[4] = {};
      for (int r = 0; r < TILE; ++r) {
        const float f = fk[r];
        const float4 v = *reinterpret_cast<const float4*>(d + r * C + j0);
        s[0] = fmaf(f, v.x, s[0]); s[1] = fmaf(f, v.y, s[1]);
        s[2] = fmaf(f, v.z, s[2]); s[3] = fmaf(f, v.w, s[3]);
      }
      float4* p = reinterpret_cast<float4*>(
          (k < 8 ? gp_f + k * C : gp_d + (k - 8) * C) + j0);
      float4 o = add ? *p : make_float4(0.f, 0.f, 0.f, 0.f);
      *p = make_float4(o.x + s[0], o.y + s[1], o.z + s[2], o.w + s[3]);
    }
    for (int r = 0; with_dxj && r < TILE; ++r) {
      const int loc = s_loc[r];
      if (loc >= 0 && (loc >> 6) == half) acc[loc * C + c] += d[r * C + c];
    }
  }
  if (!with_dxj) return;
  __syncthreads();
  if (!store_part) return;
  float4* dst = reinterpret_cast<float4*>(part + (size_t)ch * BN * C);
  for (int i = tid; i < BN * C / 4; i += THREADS) dst[i] = smem4[i];
}

}  // namespace bsms
