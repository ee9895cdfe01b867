// Kernel 8: the receiver-sorted segment sum (see ../segment_sum.py).
//
//   out[r] = Σ_{i ∈ [row_ptr[r], row_ptr[r+1])} feat[idx[i]]      (f32)
//
// idx is the layout's `row_slots` (receiver sums) or `row_send` (sender
// sums through the reverse edges: the same lists, so the same row_ptr and
// the same long rows). One launch of the row-ordered gather
// (`row_gather.cuh`): a warp walks four short lists as one range, each
// list of more than `piece` slots gets a block of its own, in pieces over
// its warps. A row with no slot comes out zero. A batch over the one layout
// (feat [n_batch][e_pad][W], out [n_batch][n_rows][W]) is the same launch
// with the sample as the grid's y index: each sample's lists, order and
// sums are those of a call on that sample alone.
//
// Rows of the latent width W (128 or 256, `with_width`), summed C = 128
// columns at a time, one column block a grid z index: each block walks the
// same lists in the same order, so at W = 256 each 128-column half of the
// output is the bits of a W = 128 call on that half of feat.
#include "row_gather.cuh"

using namespace bsms;

namespace {

template <typename T, int LD>
__global__ void __launch_bounds__(THREADS, GATHER_SUM_MIN_BLOCKS)
segment_sum_kernel(const T* __restrict__ feat, const int* __restrict__ row_ptr,
                   const int* __restrict__ idx,
                   const int* __restrict__ long_rows, int n_rows, int piece,
                   float* __restrict__ out, size_t feat_stride,
                   size_t out_stride) {
  gather_rows<false, WARP_ROWS, LD>(feat, ListedSlots{idx}, StoreRows{},
                                    row_ptr, long_rows, n_rows, piece, out,
                                    feat_stride, out_stride);
}

template <typename T>
int launch(const void* feat, const void* row_ptr, const void* idx,
           const void* long_rows, int n_rows, int n_long, int piece,
           int n_batch, int e_pad, int width, void* out, void* stream) {
  if (n_rows < 1 || n_long < 0 || piece < 1 || n_batch < 1 ||
      n_batch > MAX_BATCH || e_pad < 1)
    return (int)cudaErrorInvalidValue;
  return with_width(width, [&](auto w) {
    constexpr int LD = decltype(w)::value;
    segment_sum_kernel<T, LD>
        <<<gather_grid(n_rows, n_long, n_batch, WARP_ROWS, LD / C), THREADS,
           0, (cudaStream_t)stream>>>(
            (const T*)feat, (const int*)row_ptr, (const int*)idx,
            (const int*)long_rows, n_rows, piece, (float*)out,
            (size_t)e_pad * LD, (size_t)n_rows * LD);
    return (int)cudaGetLastError();
  });
}

}  // namespace

#define SEGMENT_SUM(NAME, T)                                                 \
  extern "C" int NAME(const void* feat, const void* row_ptr, const void* idx, \
                      const void* long_rows, int n_rows, int n_long,         \
                      int piece, int n_batch, int e_pad, int width,          \
                      void* out, void* stream) {                             \
    return launch<T>(feat, row_ptr, idx, long_rows, n_rows, n_long, piece,   \
                     n_batch, e_pad, width, out, stream);                    \
  }

SEGMENT_SUM(segment_sum_f32, float)
SEGMENT_SUM(segment_sum_bf16, __nv_bfloat16)
