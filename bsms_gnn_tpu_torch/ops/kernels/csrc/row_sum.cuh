// The per-row slot sum of kernel 10 (agg_node.cu, a short list or one
// piece of a long one): one warp sums one output row's listed feature rows,
// each lane four neighbouring columns, in list order and in f32 (no
// atomics: a result repeats from run to run, and equals a sequential f32
// sum in slot order). Also the lane loads (`load4`) and adds (`add4`) of
// the other kernels.
#pragma once

#include "common.cuh"

namespace bsms {

constexpr int ROW_UNROLL = 8;  // feature rows in flight per warp

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void add4(float4& s, const float4 v) {
  s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
}

// Σ_{i ∈ [i0, i1)} feat[idx[i]·ld + col .. col + 3], added in i order. The
// loads of ROW_UNROLL rows are issued before their adds, so a warp keeps
// that many rows in flight; the adds stay in list order.
template <typename T>
__device__ __forceinline__ float4 row_sum(const T* __restrict__ feat,
                                          const int* __restrict__ idx,
                                          int i0, int i1, int ld, int col) {
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  int i = i0;
  for (; i + ROW_UNROLL <= i1; i += ROW_UNROLL) {
    float4 v[ROW_UNROLL];
#pragma unroll
    for (int u = 0; u < ROW_UNROLL; ++u)
      v[u] = load4(feat + (size_t)__ldg(idx + i + u) * ld + col);
#pragma unroll
    for (int u = 0; u < ROW_UNROLL; ++u) add4(s, v[u]);
  }
  for (; i < i1; ++i) add4(s, load4(feat + (size_t)__ldg(idx + i) * ld + col));
  return s;
}

}  // namespace bsms
