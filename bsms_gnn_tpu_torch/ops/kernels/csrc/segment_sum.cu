// Kernel 8: the receiver-sorted segment sum (see ../segment_sum.py).
//
//   out[r] = Σ_{i ∈ [row_ptr[r], row_ptr[r+1])} feat[idx[i]]      (f32)
//
// idx is the layout's `row_slots` (receiver sums) or `row_send` (sender
// sums through the reverse edges: the same lists, so the same row_ptr and
// the same long rows). One launch of the row-ordered gather
// (`row_gather.cuh`): a warp walks four short lists as one range, each
// list of more than `piece` slots gets a block of its own, in pieces over
// its warps. A row with no slot comes out zero.
#include "row_gather.cuh"

using namespace bsms;

namespace {

template <typename T>
__global__ void __launch_bounds__(THREADS, GATHER_SUM_MIN_BLOCKS)
segment_sum_kernel(const T* __restrict__ feat, const int* __restrict__ row_ptr,
                   const int* __restrict__ idx,
                   const int* __restrict__ long_rows, int n_rows, int piece,
                   float* __restrict__ out) {
  gather_rows<false>(feat, ListedSlots{idx}, StoreRows{}, row_ptr, long_rows,
                     n_rows, piece, out);
}

template <typename T>
int launch(const void* feat, const void* row_ptr, const void* idx,
           const void* long_rows, int n_rows, int n_long, int piece, void* out,
           void* stream) {
  if (n_rows < 1 || piece < 1) return (int)cudaErrorInvalidValue;
  segment_sum_kernel<T><<<gather_blocks(n_rows, n_long), THREADS, 0,
                          (cudaStream_t)stream>>>(
      (const T*)feat, (const int*)row_ptr, (const int*)idx,
      (const int*)long_rows, n_rows, piece, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

#define SEGMENT_SUM(NAME, T)                                                 \
  extern "C" int NAME(const void* feat, const void* row_ptr, const void* idx, \
                      const void* long_rows, int n_rows, int n_long,         \
                      int piece, void* out, void* stream) {                  \
    return launch<T>(feat, row_ptr, idx, long_rows, n_rows, n_long, piece,   \
                     out, stream);                                           \
  }

SEGMENT_SUM(segment_sum_f32, float)
SEGMENT_SUM(segment_sum_bf16, __nv_bfloat16)
