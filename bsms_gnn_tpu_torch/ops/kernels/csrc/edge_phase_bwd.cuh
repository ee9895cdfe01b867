// The backward chunk walk of kernel 14 (see ../fused_gmp_k.py), with the
// forward recomputed in the kernel and the windowed front of the chunk
// walks (edge_tile.cuh's edge_tile_pre). Kernels 5, 11, 12 and 13's
// backwards run the persistent tile walk of edge_bwd_tiles.cuh instead.
//
// For the aggregate's cotangent g, each unmasked slot e gets the edge
// cotangent g[recv_e] (zero on masked slots), runs the LayerNorm backward
// and the tail layers in reverse, and yields
//   dpre[e]  the cotangent of its first-layer pre-activation,
//   dxj[n]   = Σ_{e: recv(e)=n} dpre[e],
//   dwf8     = fiber_t · dpre,  dW[l], db[l]  the tail's weight gradients.
//
// One block per edge chunk walks it in 64-slot tiles, keeping every tail
// layer's input, the running cotangent and the chunk's 128-row dxj block in
// shared memory (each block of kernel 14's cluster names its chunk,
// `chunk`, and leaves the dxj block in shared memory for the cluster to
// sum). The weight gradients: each chunk adds its
// tiles into its own partial in device memory, in tile order, and the
// partials are summed in chunk order (no atomics). A chunk's partial is
// [dW | db | dwf8].
#pragma once

#include "backward.cuh"
#include "edge_tile.cuh"

namespace bsms {

constexpr int MAX_BWD_LAYERS = 3;

inline size_t edge_bwd_smem_bytes(int n_layers) {
  return sizeof(float) *
             (BN * C + (size_t)(n_layers + 1) * TILE * C + KS * C + 8 * C +
              8 * TILE + TILE) +
         sizeof(int) * 3 * TILE;
}

// Floats of one chunk's weight-gradient partial.
__host__ __device__ inline int edge_grad_size(int n_layers) {
  return n_layers * C * C + n_layers * C + 8 * C;
}

template <typename T, bool BF16>
__device__ __forceinline__ void edge_phase_bwd_chunk(
    const float* __restrict__ fiber_t, const T* __restrict__ xwi,
    const T* __restrict__ xj, const float* __restrict__ wf8,
    const float* __restrict__ W, const float* __restrict__ B,
    const float* __restrict__ WT, const float* __restrict__ g, int n_layers,
    const int* __restrict__ send_win, const int* __restrict__ win_base,
    const int* __restrict__ receivers, const int* __restrict__ chunk_block,
    int e_pad, int edge_block, int window, float* __restrict__ gpart,
    T* __restrict__ dpre, int chunk) {
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);  // [BN][C] dxj block
  float* hs = acc + BN * C;         // [n_layers][TILE][C] tail layer inputs
  float* d = hs + (size_t)n_layers * TILE * C;  // [TILE][C] LN out, cotangent
  float* wslab = d + TILE * C;                  // [KS][C] staged weights
  float* wf = wslab + KS * C;                   // [8][C] fiber weights
  float* fib = wf + 8 * C;                      // [8][TILE] fiber stream
  float* inv = fib + 8 * TILE;                  // [TILE] LN 1/std
  int* s_row = reinterpret_cast<int*>(inv + TILE);
  int* s_recv = s_row + TILE;
  int* s_loc = s_recv + TILE;

  const int tid = threadIdx.x, ch = chunk;
  const int lane = tid & 31, warp = tid >> 5;
  const int base = win_base[ch] * (window / 2);
  const int row0 = chunk_block[ch] * BN;
  const size_t wsize = (size_t)n_layers * C * C;
  float* gp = gpart + (size_t)ch * edge_grad_size(n_layers);
  float* gp_b = gp + wsize;                   // db [n_layers][C]
  float* gp_f = gp_b + (size_t)n_layers * C;  // dwf8 [8][C]
  for (int i = tid; i < BN * C; i += THREADS) acc[i] = 0.f;
  load_first_layer<BF16, false>(wf8, nullptr, nullptr, 0, wf, nullptr,
                                nullptr);

  const int c = tid & (C - 1);
  const int half = tid >> 7;
  const EdgeSlots slots{s_row, s_recv, s_loc, fib};
  for (int t0 = ch * edge_block; t0 < (ch + 1) * edge_block; t0 += TILE) {
    const bool add = t0 != ch * edge_block;  // the chunk's first tile stores
    // Recompute: relu(pre) into hs[0], the tail keeping each layer's input,
    // the LayerNorm output into d.
    edge_tile_pre<T, BF16>(t0, base, row0, e_pad, window, fiber_t, xwi, xj,
                           send_win, receivers, wf, slots, hs);
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
    // d is now dpre: stored (bf16 in BF16 mode, which is also the operand
    // of the dxj and dwf8 sums), then the fiber-weighted sums of dpre (rows
    // of fiber_t) and the dxj block.
    if (BF16) tile_round_bf16(d);
    else __syncthreads();
    for (int i = tid; i < TILE * C; i += THREADS)
      store(&dpre[(size_t)t0 * C + i], d[i]);
    for (int k = warp; k < 8; k += THREADS / 32) {
      const int j0 = lane * 4;
      const float* fk = fib + k * TILE;
      float s[4] = {};
      for (int r = 0; r < TILE; ++r) {
        const float f = fk[r];
        const float4 v = *reinterpret_cast<const float4*>(d + r * C + j0);
        s[0] = fmaf(f, v.x, s[0]); s[1] = fmaf(f, v.y, s[1]);
        s[2] = fmaf(f, v.z, s[2]); s[3] = fmaf(f, v.w, s[3]);
      }
      float4* p = reinterpret_cast<float4*>(gp_f + k * C + j0);
      float4 o = add ? *p : make_float4(0.f, 0.f, 0.f, 0.f);
      *p = make_float4(o.x + s[0], o.y + s[1], o.z + s[2], o.w + s[3]);
    }
    for (int r = 0; r < TILE; ++r) {
      const int loc = s_loc[r];
      if (loc >= 0 && (loc >> 6) == half) acc[loc * C + c] += d[r * C + c];
    }
  }
  __syncthreads();
}

}  // namespace bsms
