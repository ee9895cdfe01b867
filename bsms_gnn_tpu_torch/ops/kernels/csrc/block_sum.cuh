// The second pass of kernels 1, 4 and 14: each edge chunk's block (kernel
// 14: each group of chunks) wrote its share of one 128-row output block to
// part[chunk]; this adds the shares of every output block in chunk order.
#pragma once

#include "common.cuh"

namespace bsms {

// out[b·BN + r][c] = Σ_{ch ∈ [chunk_ptr[b], chunk_ptr[b+1])} part[ch][r][c],
// summed in chunk order (deterministic); zero for a block with no chunk.
// With `stride` s > 1 only every s-th chunk of a block holds a part (the
// first of each group of s, kernel 14). Grid (n_blocks, BN·C /
// (4·THREADS)): one float4 of the block per thread.
__global__ void __launch_bounds__(THREADS)
block_sum_kernel(const float* __restrict__ part, const int* __restrict__ chunk_ptr,
                 float* __restrict__ out, int stride) {
  const int blk = blockIdx.x;
  const int i = blockIdx.y * THREADS + threadIdx.x;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  const int c1 = chunk_ptr[blk + 1];
  for (int ch = chunk_ptr[blk]; ch < c1; ch += stride) {
    const float4 p = reinterpret_cast<const float4*>(part + (size_t)ch * BN * C)[i];
    s.x += p.x; s.y += p.y; s.z += p.z; s.w += p.w;
  }
  reinterpret_cast<float4*>(out + (size_t)blk * BN * C)[i] = s;
}

inline cudaError_t launch_block_sum(const float* part, const int* chunk_ptr,
                                    float* out, int n_blocks,
                                    cudaStream_t stream, int stride = 1) {
  block_sum_kernel<<<dim3(n_blocks, BN * C / (4 * THREADS)), THREADS, 0,
                     stream>>>(part, chunk_ptr, out, stride);
  return cudaGetLastError();
}

}  // namespace bsms
