// Kernel 9: the accumulating segment sum (see ../segment_sum_accum.py).
//
//   out[r] = acc[r] + Σ_{i ∈ [row_ptr[r], row_ptr[r+1])} feat[idx[i]]      (f32)
//
// or, with no acc (the store form, the skip-empty gathers' backward), the
// sum alone. idx is the layout's `row_slots` (receiver sums) or `row_send`
// (sender sums through the reverse edges: the same lists, so the same
// row_ptr and the same long rows). One launch of the row-ordered gather
// (`row_gather.cuh`), as kernel 8 but a warp to each short list: each list
// of more than `piece` slots gets a block of its own, in pieces over its
// warps. The sum runs from zero in the gather's order and is added onto
// acc's row at the end; acc is read once, beside the walk's first loads,
// and left as it is (autograd keeps it). Every row is a list, so every row
// of out is written: a row with no slot (a block of a skip-empty layout
// that owns no chunk) comes out as acc, or zero in the store form.
#include "row_gather.cuh"

using namespace bsms;

namespace {

// Short lists of a warp. A residual sub-level's lists hold a few slots
// each (a median of 2 to 4 on the cylinder), and its launch few rows
// (N_pad 512 to 2,048): one list a warp gives four times the warps of
// the gather's four, and read 0.0025 ms at the cylinder's level 1 where
// four read 0.0043 (H100, PERF.md §6).
constexpr int ACCUM_ROWS = 1;

// GATHER_MIN_BLOCKS (4 blocks per SM, 64 registers a thread): at one list a
// warp it read 0.4% faster than GATHER_SUM_MIN_BLOCKS (2) over a cylinder
// step's 30 launches, with no spill; at four lists a warp, 2 had read 13%
// faster (H100, PERF.md §6).
template <typename T, typename Dst>
__global__ void __launch_bounds__(THREADS, GATHER_MIN_BLOCKS)
segment_sum_accum_kernel(const T* __restrict__ feat,
                         const int* __restrict__ row_ptr,
                         const int* __restrict__ idx,
                         const int* __restrict__ long_rows, Dst dst,
                         int n_rows, int piece, float* __restrict__ out) {
  gather_rows<false, ACCUM_ROWS>(feat, ListedSlots{idx}, dst, row_ptr,
                                 long_rows, n_rows, piece, out);
}

template <typename T>
int launch(const void* feat, const void* row_ptr, const void* idx,
           const void* long_rows, const void* acc, int n_rows, int n_long,
           int piece, void* out, void* stream) {
  if (n_rows < 1 || piece < 1) return (int)cudaErrorInvalidValue;
  const int blocks = gather_blocks(n_rows, n_long, ACCUM_ROWS);
  const auto s = (cudaStream_t)stream;
  if (acc)
    segment_sum_accum_kernel<T><<<blocks, THREADS, 0, s>>>(
        (const T*)feat, (const int*)row_ptr, (const int*)idx,
        (const int*)long_rows, AddOnto{(const float*)acc}, n_rows, piece,
        (float*)out);
  else
    segment_sum_accum_kernel<T><<<blocks, THREADS, 0, s>>>(
        (const T*)feat, (const int*)row_ptr, (const int*)idx,
        (const int*)long_rows, StoreRows{}, n_rows, piece, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// acc may be null: the store form.
#define SEGMENT_SUM_ACCUM(NAME, T)                                           \
  extern "C" int NAME(const void* feat, const void* row_ptr, const void* idx, \
                      const void* long_rows, const void* acc, int n_rows,    \
                      int n_long, int piece, void* out, void* stream) {      \
    return launch<T>(feat, row_ptr, idx, long_rows, acc, n_rows, n_long,    \
                     piece, out, stream);                                    \
  }

SEGMENT_SUM_ACCUM(segment_sum_accum_f32, float)
SEGMENT_SUM_ACCUM(segment_sum_accum_bf16, __nv_bfloat16)
