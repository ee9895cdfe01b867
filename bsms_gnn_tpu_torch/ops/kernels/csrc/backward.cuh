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

// One row of the LayerNorm backward in a warp, V float4s a lane
// (ln_center's layout: lane l holds columns 4l + C·v .. +3):
// (g − mean(g) − normed·mean(g·normed)) · inv.
template <int V>
__device__ __forceinline__ void ln_bwd_row(const float4 (&g)[V],
                                           const float4 (&n)[V], float inv,
                                           float4 (&out)[V]) {
  float gs = g[0].x + g[0].y + g[0].z + g[0].w;
  float gn = g[0].x * n[0].x + g[0].y * n[0].y + g[0].z * n[0].z + g[0].w * n[0].w;
#pragma unroll
  for (int i = 1; i < V; ++i) {
    gs += g[i].x + g[i].y + g[i].z + g[i].w;
    gn += g[i].x * n[i].x + g[i].y * n[i].y + g[i].z * n[i].z + g[i].w * n[i].w;
  }
  const float gm = warp_sum(gs) / (C * V);
  const float gnm = warp_sum(gn) / (C * V);
#pragma unroll
  for (int i = 0; i < V; ++i)
    out[i] = make_float4((g[i].x - gm - n[i].x * gnm) * inv,
                         (g[i].y - gm - n[i].y * gnm) * inv,
                         (g[i].z - gm - n[i].z * gnm) * inv,
                         (g[i].w - gm - n[i].w * gnm) * inv);
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
