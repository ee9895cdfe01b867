// Shared device code of the backward kernels: the LayerNorm backward of one
// row and the second pass that sums the per-block weight-gradient partials
// in a fixed order (kernels 5, 6 and 11-14's backwards).
//
// The TPU kernels carry their weight gradients in scratch across a
// sequential grid. Here blocks run in no order, so each block writes its
// own partial and grad_sum_kernel adds the partials in block order: every
// gradient is the same from run to run, with no atomics.
#pragma once

#include "common.cuh"

namespace bsms {

// One row of the LayerNorm backward in a warp (each lane holds 4 columns):
// (g − mean(g) − normed·mean(g·normed)) · inv.
__device__ __forceinline__ float4 ln_bwd(float4 g, float4 n, float inv) {
  const float gm = warp_sum(g.x + g.y + g.z + g.w) / C;
  const float gnm = warp_sum(g.x * n.x + g.y * n.y + g.z * n.z + g.w * n.w) / C;
  return make_float4((g.x - gm - n.x * gnm) * inv, (g.y - gm - n.y * gnm) * inv,
                     (g.z - gm - n.z * gnm) * inv, (g.w - gm - n.w * gnm) * inv);
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
