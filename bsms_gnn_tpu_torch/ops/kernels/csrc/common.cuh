// Shared device code of the port's kernels: the row-tile GEMM (64 rows by
// default, 8·R rows in general), the non-affine LayerNorm and the MLP tail
// that kernel 10 (node_phase.cuh) runs in shared memory. Widths are fixed at
// the latent width C = 128.
//
// Precision: f32 mode is true f32 (FMA on the CUDA cores, no TF32). BF16
// mode rounds every dot operand to bf16 (round to nearest even) and
// accumulates in f32, which is what the TPU kernels' bf16 MXU dots compute.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace bsms {

constexpr int C = 128;        // latent width (lanes of every row)
constexpr int BN = 128;       // output rows per node block
constexpr int THREADS = 256;  // threads of every block
constexpr int TILE = 64;      // rows per MLP tile
constexpr int KS = 32;        // weight rows staged per GEMM step
constexpr float LN_EPS = 1e-5f;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[i][j] += Σ_k in[(R·ty + i)·C + k] · W[k·C + 4·tx + j] over k < C, for
// an (8·R)×C tile `in` in shared memory (R = 8: a TILE×C tile) and a C×C
// weight W ([in, out]) in device memory, staged KS rows at a time through
// `wslab` (rounded to bf16 in BF16 mode). Thread (tx = lane, ty = warp)
// owns rows R·ty..R·ty+R-1 and columns 4·tx..4·tx+3. Starts and ends with
// a block barrier, so the caller may overwrite `in` right after (each warp
// reads only its own rows).
template <bool BF16, int R = 8>
__device__ __forceinline__ void tile_gemm(float (&acc)[R][4],
                                          const float* in,
                                          const float* __restrict__ W,
                                          float* __restrict__ wslab) {
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  for (int k0 = 0; k0 < C; k0 += KS) {
    __syncthreads();
    const float4* src = reinterpret_cast<const float4*>(W + k0 * C);
    float4* dst = reinterpret_cast<float4*>(wslab);
    for (int i = tid; i < KS * C / 4; i += THREADS) {
      float4 w = src[i];
      if (BF16) {
        w.x = round_bf16(w.x); w.y = round_bf16(w.y);
        w.z = round_bf16(w.z); w.w = round_bf16(w.w);
      }
      dst[i] = w;
    }
    __syncthreads();
#pragma unroll 2
    for (int k = 0; k < KS; k += 4) {
      float4 a[R];
#pragma unroll
      for (int i = 0; i < R; ++i)
        a[i] = *reinterpret_cast<const float4*>(in + (R * ty + i) * C + k0 + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 w = reinterpret_cast<const float4*>(wslab + (k + kk) * C)[tx];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
          acc[i][0] = fmaf(av, w.x, acc[i][0]);
          acc[i][1] = fmaf(av, w.y, acc[i][1]);
          acc[i][2] = fmaf(av, w.z, acc[i][2]);
          acc[i][3] = fmaf(av, w.w, acc[i][3]);
        }
      }
    }
  }
  __syncthreads();
}

// out rows = acc + bias, optionally ReLU'd and rounded to bf16 (when the
// result is only ever a dot operand). `out` may alias the GEMM's input.
template <int R>
__device__ __forceinline__ void tile_store(const float (&acc)[R][4],
                                          const float* __restrict__ bias,
                                          float* out, bool relu, bool to_bf16) {
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const float4 b = reinterpret_cast<const float4*>(bias)[tx];
  const float bb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = acc[i][j] + bb[j];
      if (relu) v[j] = fmaxf(v[j], 0.f);
      if (to_bf16) v[j] = round_bf16(v[j]);
    }
    *reinterpret_cast<float4*>(out + (R * ty + i) * C + 4 * tx) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

// Non-affine LayerNorm of every row of a ROWS×C shared-memory tile, in
// place, by a block of NT threads: mean, then the mean of squared
// deviations, then (x − mean) · 1/sqrt(var + eps) — 1.0f / sqrtf (both
// IEEE-rounded without fast math) rather than rsqrtf, as the TPU kernels do.
template <int ROWS = TILE, int NT = THREADS>
__device__ __forceinline__ void tile_layer_norm(float* t) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < ROWS; r += NT / 32) {
    float4 v = reinterpret_cast<float4*>(t + r * C)[lane];
    const float mean = warp_sum(v.x + v.y + v.z + v.w) / C;
    v.x -= mean; v.y -= mean; v.z -= mean; v.w -= mean;
    const float var = warp_sum(v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w) / C;
    const float inv = 1.0f / sqrtf(var + LN_EPS);
    v.x *= inv; v.y *= inv; v.z *= inv; v.w *= inv;
    reinterpret_cast<float4*>(t + r * C)[lane] = v;
  }
  __syncthreads();
}

// The MLP tail on an (8·R)-row tile that holds relu(pre) (already rounded
// in BF16 mode): n_layers Linear layers (ReLU between them), then
// LayerNorm, all in place. W: [n_layers, C, C] ([in, out]); B: [n_layers,
// C].
template <bool BF16, int R = 8>
__device__ __forceinline__ void tile_mlp_tail(float* t, const float* __restrict__ W,
                                              const float* __restrict__ B,
                                              int n_layers, float* wslab) {
  for (int l = 0; l < n_layers; ++l) {
    float acc[R][4] = {};
    tile_gemm<BF16, R>(acc, t, W + (size_t)l * C * C, wslab);
    const bool last = l == n_layers - 1;
    tile_store(acc, B + l * C, t, !last, BF16 && !last);
  }
  __syncthreads();
  tile_layer_norm<8 * R>(t);
}

}  // namespace bsms
