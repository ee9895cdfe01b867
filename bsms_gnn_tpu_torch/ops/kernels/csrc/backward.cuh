// Shared device code of the backward kernels: the LayerNorm backward and
// the second pass that sums the per-block weight-gradient partials in a
// fixed order (kernels 5, 6 and 11-13's backwards), and, for the backward
// chunk walk of kernel 14 (edge_phase_bwd.cuh), the MLP tail's forward
// that keeps what its backward needs and the transposed tile product
// behind its weight gradients.
//
// The TPU kernels carry their weight gradients in scratch across a
// sequential grid. Here blocks run in no order, so each block writes its
// own partial and grad_sum_kernel adds the partials in block order: every
// gradient is the same from run to run, with no atomics.
#pragma once

#include "common.cuh"

namespace bsms {

// Non-affine LayerNorm of every row of a TILE×C tile in place, as
// tile_layer_norm computes it, keeping each row's 1/sqrt(var + eps).
__device__ __forceinline__ void tile_layer_norm_save(float* t, float* inv) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < TILE; r += THREADS / 32) {
    float4 v = reinterpret_cast<float4*>(t + r * C)[lane];
    const float mean = warp_sum(v.x + v.y + v.z + v.w) / C;
    v.x -= mean; v.y -= mean; v.z -= mean; v.w -= mean;
    const float var = warp_sum(v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w) / C;
    const float iv = 1.0f / sqrtf(var + LN_EPS);
    v.x *= iv; v.y *= iv; v.z *= iv; v.w *= iv;
    reinterpret_cast<float4*>(t + r * C)[lane] = v;
    if (lane == 0) inv[r] = iv;
  }
  __syncthreads();
}

// The MLP tail of a tile holding relu(pre) in hs[0], keeping every tail
// layer's input: hs[l + 1] = relu(hs[l]·W[l] + B[l]) (rounded in BF16
// mode), the last layer's output LayerNorm'd into `out`, 1/std into inv.
// Each hs[l] is a TILE×C tile, hs[l + 1] = hs[l] + TILE·C.
template <bool BF16>
__device__ __forceinline__ void tile_mlp_tail_save(float* hs, float* out,
                                                   float* inv,
                                                   const float* __restrict__ W,
                                                   const float* __restrict__ B,
                                                   int n_layers, float* wslab) {
  for (int l = 0; l < n_layers; ++l) {
    float acc[8][4] = {};
    float* in = hs + (size_t)l * TILE * C;
    tile_gemm<BF16>(acc, in, W + (size_t)l * C * C, wslab);
    const bool last = l == n_layers - 1;
    tile_store(acc, B + l * C, last ? out : in + TILE * C, !last, BF16 && !last);
  }
  __syncthreads();
  tile_layer_norm_save(out, inv);
}

// One row of the LayerNorm backward in a warp (each lane holds 4 columns):
// (g − mean(g) − normed·mean(g·normed)) · inv.
__device__ __forceinline__ float4 ln_bwd(float4 g, float4 n, float inv) {
  const float gm = warp_sum(g.x + g.y + g.z + g.w) / C;
  const float gnm = warp_sum(g.x * n.x + g.y * n.y + g.z * n.z + g.w * n.w) / C;
  return make_float4((g.x - gm - n.x * gnm) * inv, (g.y - gm - n.y * gnm) * inv,
                     (g.z - gm - n.z * gnm) * inv, (g.w - gm - n.w * gnm) * inv);
}

// acc[i][j] += Σ_r A[r·C + i0 + i] · B[r·C + j0 + j] over the TILE rows,
// with i0 = 8·(tid / 16), j0 = 8·(tid % 16): the [C, C] product AᵀB of two
// TILE×C shared-memory tiles (operands already rounded in BF16 mode).
__device__ __forceinline__ void tile_gemm_tn(float (&acc)[8][8], const float* A,
                                             const float* B) {
  const int i0 = (threadIdx.x >> 4) * 8, j0 = (threadIdx.x & 15) * 8;
#pragma unroll 2
  for (int r = 0; r < TILE; ++r) {
    const float4 a0 = *reinterpret_cast<const float4*>(A + r * C + i0);
    const float4 a1 = *reinterpret_cast<const float4*>(A + r * C + i0 + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(B + r * C + j0);
    const float4 b1 = *reinterpret_cast<const float4*>(B + r * C + j0 + 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// dst[(i0 + i)·C + j0 + j] = acc[i][j], or += when `add` (in tile_gemm_tn's
// layout; each thread touches only its own elements).
__device__ __forceinline__ void store_tn(const float (&acc)[8][8], float* dst,
                                         bool add) {
  const int i0 = (threadIdx.x >> 4) * 8, j0 = (threadIdx.x & 15) * 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float4* p = reinterpret_cast<float4*>(dst + (size_t)(i0 + i) * C + j0);
    float4 v0 = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    float4 v1 = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    if (add) {
      const float4 o0 = p[0], o1 = p[1];
      v0.x += o0.x; v0.y += o0.y; v0.z += o0.z; v0.w += o0.w;
      v1.x += o1.x; v1.y += o1.y; v1.z += o1.z; v1.w += o1.w;
    }
    p[0] = v0;
    p[1] = v1;
  }
}

// out = acc ⊙ (mask > 0) in tile_gemm's layout (the ReLU's backward: mask
// is the layer's input). `out` may alias the GEMM's input.
__device__ __forceinline__ void tile_store_masked(const float (&acc)[8][4],
                                                  const float* mask, float* out) {
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int o = (8 * ty + i) * C + 4 * tx;
    const float4 m = *reinterpret_cast<const float4*>(mask + o);
    *reinterpret_cast<float4*>(out + o) = make_float4(
        m.x > 0.f ? acc[i][0] : 0.f, m.y > 0.f ? acc[i][1] : 0.f,
        m.z > 0.f ? acc[i][2] : 0.f, m.w > 0.f ? acc[i][3] : 0.f);
  }
}

// Σ over the TILE rows of column threadIdx.x (< C) of t, in row order.
__device__ __forceinline__ float tile_colsum(const float* t) {
  float s = 0.f;
  for (int r = 0; r < TILE; ++r) s += t[r * C + threadIdx.x];
  return s;
}

// Rounds a TILE×C tile to bf16 in place, between two block barriers.
__device__ __forceinline__ void tile_round_bf16(float* t) {
  __syncthreads();
  for (int i = threadIdx.x; i < TILE * C; i += THREADS) t[i] = round_bf16(t[i]);
  __syncthreads();
}

// out[k] = Σ_{p < n_parts} part[p·size + k], in p order; one float4 per
// thread (size a multiple of 4).
__global__ void __launch_bounds__(THREADS)
grad_sum_kernel(const float* __restrict__ part, int n_parts, int size4,
                float* __restrict__ out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= size4) return;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int p = 0; p < n_parts; ++p) {
    const float4 v = reinterpret_cast<const float4*>(part + (size_t)p * size4 * 4)[i];
    s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
  }
  reinterpret_cast<float4*>(out)[i] = s;
}

inline cudaError_t launch_grad_sum(const float* part, int n_parts, int size,
                                   float* out, cudaStream_t stream) {
  const int size4 = size / 4;
  grad_sum_kernel<<<(size4 + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      part, n_parts, size4, out);
  return cudaGetLastError();
}

}  // namespace bsms
