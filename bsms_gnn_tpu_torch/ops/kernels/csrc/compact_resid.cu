// Kernel 2: the compact residual accumulate (see ../compact_resid.py),
// replacing the TPU kernel `bsms_gnn_tpu/ops/pallas/compact_resid.py::
// compact_accum` (`_get_call`):
//
//   acc[rows[k]] += Σ_{i ∈ [row_ptr[k], row_ptr[k+1])} vals[i]
//
// in place on acc, over the distinct receivers rows[k] of the real compact
// rows (`cr_rows`, ascending) and their ranges of compact rows
// (`cr_row_ptr`: the rows are sorted by receiver, so each receiver's are
// contiguous). Pad rows are listed nowhere and add nothing, and accumulator
// rows that no real row reaches are neither read nor written.
//
// What bounds it: bytes (each real value row read once, each reached
// accumulator row read and written once); at the 5k mesh a launch moves
// about a MB, so there the latency of its chain of dependent loads is its
// time.
//
// Design: the row-ordered gather of row_gather.cuh over those ranges, with
// the value row of position i the compact row i itself (no slot table, no
// weight), adding each list's sum onto its accumulator row; a receiver of
// more than 32 compact rows (`cr_long`) gets a block of its own. A warp's
// chain is row_ptr and rows → vals and acc → acc. One launch, no atomics.
// A batch over the one residual (vals [B, R_pad, C], acc [B, n_pad, C]) is
// the grid's y extent, each sample added as a call on it alone.
//
// Why not a shared-memory copy of each visited 128-row block of acc, as the
// TPU kernel keeps its output block: every block a visit reached then moves
// whole (5.4 MB where 0.9 MB is needed at the 5k airfoil's level 0), added
// to by serial read-modify-writes, and it ran 2.4x slower than `index_add_`
// there.
#include "row_gather.cuh"

using namespace bsms;

namespace {

// LD: the row width (the latent width, 128 or 256).
template <typename T, bool BF16, int LD>
__global__ void __launch_bounds__(THREADS, GATHER_SUM_MIN_BLOCKS)
compact_gather_kernel(const T* __restrict__ vals,
                      const int* __restrict__ rows,
                      const int* __restrict__ row_ptr,
                      const int* __restrict__ long_rows, int n_rows,
                      int piece, float* __restrict__ acc, size_t vals_stride,
                      size_t acc_stride) {
  gather_rows<BF16, WARP_ROWS, LD>(vals, RangeRows{}, AddToRows{rows},
                                   row_ptr, long_rows, n_rows, piece, acc,
                                   vals_stride, acc_stride);
}

// vals [n_batch][vals_rows][width], acc [n_batch][acc_rows][width]: rows of
// the latent width (128 or 256), one column block of C a grid z index.
template <typename T, bool BF16>
int launch(const void* vals, const void* rows, const void* row_ptr,
           const void* long_rows, int n_rows, int n_long, int piece,
           int n_batch, int vals_rows, int acc_rows, int width, void* acc,
           void* stream) {
  if (n_rows < 1 || n_long < 0 || piece < 1 || n_batch < 1 ||
      n_batch > MAX_BATCH || vals_rows < 1 || acc_rows < 1)
    return (int)cudaErrorInvalidValue;
  return with_width(width, [&](auto w) {
    constexpr int LD = decltype(w)::value;
    compact_gather_kernel<T, BF16, LD>
        <<<gather_grid(n_rows, n_long, n_batch, WARP_ROWS, LD / C), THREADS,
           0, (cudaStream_t)stream>>>(
            (const T*)vals, (const int*)rows, (const int*)row_ptr,
            (const int*)long_rows, n_rows, piece, (float*)acc,
            (size_t)vals_rows * LD, (size_t)acc_rows * LD);
    return (int)cudaGetLastError();
  });
}

}  // namespace

#define COMPACT_ACCUM(NAME, T, BF16)                                          \
  extern "C" int NAME(const void* vals, const void* rows,                    \
                      const void* row_ptr, const void* long_rows,            \
                      int n_rows, int n_long, int piece, int n_batch,        \
                      int vals_rows, int acc_rows, int width, void* acc,     \
                      void* stream) {                                        \
    return launch<T, BF16>(vals, rows, row_ptr, long_rows, n_rows, n_long,   \
                           piece, n_batch, vals_rows, acc_rows, width, acc,  \
                           stream);                                          \
  }

COMPACT_ACCUM(compact_accum_f32, float, false)
COMPACT_ACCUM(compact_accum_bf16, __nv_bfloat16, true)
