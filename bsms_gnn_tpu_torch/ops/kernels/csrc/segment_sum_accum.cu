// Kernel 9: the accumulating segment sum (see ../segment_sum_accum.py).
//
//   out[r] = acc[r] + Σ_{i ∈ [row_ptr[r], row_ptr[r+1])} feat[idx[i]]      (f32)
//
// idx is the layout's `row_slots` (receiver sums) or `row_send` (sender
// sums through the reverse edges). Kernel 8's walk (`row_sum.cuh`): one warp
// per output row, eight rows per block, each lane four columns of every
// 128-column group, the listed rows added in list order onto the row of
// acc. A row with no slot (a block of a skip-empty layout that owns no
// chunk) comes out as acc.
#include "row_sum.cuh"

using namespace bsms;

namespace {

constexpr int ROWS_PER_BLOCK = THREADS / 32;

template <typename T>
__global__ void __launch_bounds__(THREADS)
segment_sum_accum_kernel(const T* __restrict__ feat,
                         const int* __restrict__ row_ptr,
                         const int* __restrict__ idx,
                         const float* __restrict__ acc, int n_rows, int c,
                         float* __restrict__ out) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int lane = threadIdx.x & 31;
  const int i0 = row_ptr[row], i1 = row_ptr[row + 1];
  for (int col = 4 * lane; col < c; col += 128) {
    const size_t at = (size_t)row * c + col;
    float4 s = *reinterpret_cast<const float4*>(acc + at);
    if (i1 > i0) add4(s, row_sum(feat, idx, i0, i1, c, col));
    *reinterpret_cast<float4*>(out + at) = s;
  }
}

template <typename T>
int launch(const void* feat, const void* row_ptr, const void* idx,
           const void* acc, int n_rows, int c, void* out, void* stream) {
  if (c % 128) return (int)cudaErrorInvalidValue;
  const int blocks = (n_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  segment_sum_accum_kernel<T><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)feat, (const int*)row_ptr, (const int*)idx, (const float*)acc,
      n_rows, c, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int segment_sum_accum_f32(const void* feat, const void* row_ptr,
                                     const void* idx, const void* acc,
                                     int n_rows, int c, void* out,
                                     void* stream) {
  return launch<float>(feat, row_ptr, idx, acc, n_rows, c, out, stream);
}

extern "C" int segment_sum_accum_bf16(const void* feat, const void* row_ptr,
                                      const void* idx, const void* acc,
                                      int n_rows, int c, void* out,
                                      void* stream) {
  return launch<__nv_bfloat16>(feat, row_ptr, idx, acc, n_rows, c, out,
                               stream);
}
