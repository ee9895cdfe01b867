// Shared device code of the port's kernels: the row-tile GEMM (64 rows by
// default, 8·R rows in general), the non-affine LayerNorm and the MLP tail
// that kernel 10 (node_phase.cuh) runs in shared memory. C = 128 is the
// columns one warp covers in a row (4 a lane) and the latent width of
// kernels 9, 11, 12, 14 and 15; kernels 1-8, 10 and 13 take rows of any
// multiple of it that their wrappers name (a latent width of 256: V = 2
// float4s a lane, `ln_center`).
//
// Precision: f32 mode is true f32 (FMA on the CUDA cores, no TF32). BF16
// mode rounds every dot operand to bf16 (round to nearest even) and
// accumulates in f32, which is what the TPU kernels' bf16 MXU dots compute.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace bsms {

constexpr int C = 128;        // latent width (lanes of every row)
constexpr int BN = 128;       // output rows per node block
constexpr int THREADS = 256;  // threads of every block
constexpr int TILE = 64;      // rows per MLP tile
constexpr int KS = 32;        // weight rows staged per GEMM step
constexpr float LN_EPS = 1e-5f;

// Calls fn(std::integral_constant<int, W>{}) for a latent width W of 128 or
// 256 (the widths kernels 1-7 are built for), or returns
// cudaErrorInvalidValue.
template <typename Fn>
int with_width(int width, Fn&& fn) {
  if (width == 128) return fn(std::integral_constant<int, 128>{});
  if (width == 256) return fn(std::integral_constant<int, 256>{});
  return (int)cudaErrorInvalidValue;
}

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

// The LayerNorm statistics of one row held by a warp, V float4s a lane
// (lane l holding columns 4l + C·v .. +3 of a row of C·V): centres the row
// in place and returns 1/sqrt(var + eps), 1.0f / sqrtf (both IEEE-rounded
// without fast math) rather than rsqrtf, as the TPU kernels do. At V = 1
// these are the sums the kernels always took, term for term.
template <int V>
__device__ __forceinline__ float ln_center(float4 (&v)[V]) {
  float s = v[0].x + v[0].y + v[0].z + v[0].w;
#pragma unroll
  for (int i = 1; i < V; ++i) s += v[i].x + v[i].y + v[i].z + v[i].w;
  const float mean = warp_sum(s) / (C * V);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    v[i].x -= mean; v[i].y -= mean; v[i].z -= mean; v[i].w -= mean;
  }
  float q = v[0].x * v[0].x + v[0].y * v[0].y + v[0].z * v[0].z + v[0].w * v[0].w;
#pragma unroll
  for (int i = 1; i < V; ++i)
    q += v[i].x * v[i].x + v[i].y * v[i].y + v[i].z * v[i].z + v[i].w * v[i].w;
  const float var = warp_sum(q) / (C * V);
  return 1.0f / sqrtf(var + LN_EPS);
}

// acc[i][4v + j] += Σ_k in[(R·ty + i)·CW + k] · W[k·CW + 128v + 4·tx + j]
// over k < CW, for an (8·R)×CW tile `in` in shared memory (R = 8: a
// TILE×CW tile) and a CW×CW weight W ([in, out]) in device memory, staged
// KS rows at a time through `wslab` (rounded to bf16 in BF16 mode). Thread
// (tx = lane, ty = warp) owns rows R·ty..R·ty+R-1 and columns 4·tx + 128v
// .. +3 of each 128-column block v < CW / C. Each output is one FMA chain
// over k in order, whatever CW. Starts and ends with a block barrier, so
// the caller may overwrite `in` right after (each warp reads only its own
// rows).
template <bool BF16, int R = 8, int CW = C>
__device__ __forceinline__ void tile_gemm(float (&acc)[R][4 * (CW / C)],
                                          const float* in,
                                          const float* __restrict__ W,
                                          float* __restrict__ wslab) {
  constexpr int V = CW / C;
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  for (int k0 = 0; k0 < CW; k0 += KS) {
    __syncthreads();
    const float4* src = reinterpret_cast<const float4*>(W + k0 * CW);
    float4* dst = reinterpret_cast<float4*>(wslab);
    for (int i = tid; i < KS * CW / 4; i += THREADS) {
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
        a[i] = *reinterpret_cast<const float4*>(in + (R * ty + i) * CW + k0 + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float4 w[V];
#pragma unroll
        for (int v = 0; v < V; ++v)
          w[v] = reinterpret_cast<const float4*>(wslab + (k + kk) * CW)[tx + 32 * v];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            acc[i][4 * v + 0] = fmaf(av, w[v].x, acc[i][4 * v + 0]);
            acc[i][4 * v + 1] = fmaf(av, w[v].y, acc[i][4 * v + 1]);
            acc[i][4 * v + 2] = fmaf(av, w[v].z, acc[i][4 * v + 2]);
            acc[i][4 * v + 3] = fmaf(av, w[v].w, acc[i][4 * v + 3]);
          }
        }
      }
    }
  }
  __syncthreads();
}

// out rows = acc + bias, optionally ReLU'd and rounded to bf16 (when the
// result is only ever a dot operand), in tile_gemm's layout. `out` may
// alias the GEMM's input.
template <int R, int CW = C>
__device__ __forceinline__ void tile_store(const float (&acc)[R][4 * (CW / C)],
                                          const float* __restrict__ bias,
                                          float* out, bool relu, bool to_bf16) {
  constexpr int V = CW / C;
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
#pragma unroll
  for (int vv = 0; vv < V; ++vv) {
    const float4 b = reinterpret_cast<const float4*>(bias)[tx + 32 * vv];
    const float bb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[i][4 * vv + j] + bb[j];
        if (relu) v[j] = fmaxf(v[j], 0.f);
        if (to_bf16) v[j] = round_bf16(v[j]);
      }
      *reinterpret_cast<float4*>(out + (R * ty + i) * CW + 4 * tx + C * vv) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// Non-affine LayerNorm of every row of a ROWS×CW shared-memory tile, in
// place, by a block of NT threads, a warp a row (`ln_center`, as kernels
// 3 and 4 take it: lane l holds columns 4l + 128v).
template <int ROWS = TILE, int NT = THREADS, int CW = C>
__device__ __forceinline__ void tile_layer_norm(float* t) {
  constexpr int V = CW / C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < ROWS; r += NT / 32) {
    float4 v[V];
#pragma unroll
    for (int vv = 0; vv < V; ++vv)
      v[vv] = reinterpret_cast<float4*>(t + r * CW)[lane + 32 * vv];
    const float inv = ln_center<V>(v);
#pragma unroll
    for (int vv = 0; vv < V; ++vv) {
      v[vv].x *= inv; v[vv].y *= inv; v[vv].z *= inv; v[vv].w *= inv;
      reinterpret_cast<float4*>(t + r * CW)[lane + 32 * vv] = v[vv];
    }
  }
  __syncthreads();
}

// The MLP tail on an (8·R)-row tile of CW columns that holds relu(pre)
// (already rounded in BF16 mode): n_layers Linear layers (ReLU between
// them), then LayerNorm, all in place. W: [n_layers, CW, CW] ([in, out]);
// B: [n_layers, CW].
template <bool BF16, int R = 8, int CW = C>
__device__ __forceinline__ void tile_mlp_tail(float* t, const float* __restrict__ W,
                                              const float* __restrict__ B,
                                              int n_layers, float* wslab) {
  for (int l = 0; l < n_layers; ++l) {
    float acc[R][4 * (CW / C)] = {};
    tile_gemm<BF16, R, CW>(acc, t, W + (size_t)l * CW * CW, wslab);
    const bool last = l == n_layers - 1;
    tile_store<R, CW>(acc, B + l * CW, t, !last, BF16 && !last);
  }
  __syncthreads();
  tile_layer_norm<8 * R, THREADS, CW>(t);
}

}  // namespace bsms
