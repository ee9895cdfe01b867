// Kernel 7: the transposed windowed sum of a level (see ../windowed.py),
// replacing the TPU kernel `bsms_gnn_tpu/ops/pallas/windowed.py::
// windowed_send_sum_raw` (`_get_send_call`):
//
//   out[n] = Σ_{in-window e: send(e)=n} vals[e],
//   send(e) = win_base[chunk(e)]·W/2 + send_win[e]
//
// What bounds it: bytes. Each in-window slot's row is read once (512
// bytes, 256 in bf16) for 128 additions, and the output written once; at
// the 5k mesh a launch moves a few MB, so there the latency of its chain of
// dependent loads is its time.
//
// Design: the row-ordered gather of row_gather.cuh over the level's
// sender-row lists (`send_row_ptr`, `send_row_slots`: every slot with
// send_win < W, whatever its receiver, as the TPU kernel's one-hot tests
// send_win alone, grouped by sender row in slot order) and its rows of more
// than 32 of them (`send_long`). The value row of a slot is the slot
// itself, so a warp's chain is row_ptr → slots → vals; no weight. A sender
// row with no slot comes out zero. One launch, no scratch, no atomics.
//
// Why not a shared-memory copy of each chunk's window, as the TPU kernel
// keeps its output block: a serial read-modify-write per slot on one block
// per SM, and a part per chunk that a second kernel sums (10.5 MB each way
// at the 5k airfoil's level 0) ran 1.8x slower than `index_add_` there.
#include "row_gather.cuh"

using namespace bsms;

namespace {

template <typename T, bool BF16>
__global__ void __launch_bounds__(THREADS, GATHER_SUM_MIN_BLOCKS)
send_gather_kernel(const T* __restrict__ vals,
                   const int* __restrict__ row_ptr,
                   const int* __restrict__ row_slots,
                   const int* __restrict__ long_rows, int n_rows, int piece,
                   float* __restrict__ out) {
  gather_rows<BF16>(vals, ListedSlots{row_slots}, StoreRows{}, row_ptr,
                    long_rows, n_rows, piece, out);
}

template <typename T, bool BF16>
int launch(const void* vals, const void* row_ptr, const void* row_slots,
           const void* long_rows, int n_rows, int n_long, int piece,
           void* out, void* stream) {
  if (n_rows < 1 || n_long < 0 || piece < 1) return (int)cudaErrorInvalidValue;
  send_gather_kernel<T, BF16><<<gather_blocks(n_rows, n_long), THREADS, 0,
                                (cudaStream_t)stream>>>(
      (const T*)vals, (const int*)row_ptr, (const int*)row_slots,
      (const int*)long_rows, n_rows, piece, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

#define WINDOWED_SEND_SUM(NAME, T, BF16)                                      \
  extern "C" int NAME(const void* vals, const void* row_ptr,                 \
                      const void* row_slots, const void* long_rows,          \
                      int n_rows, int n_long, int piece, void* out,          \
                      void* stream) {                                        \
    return launch<T, BF16>(vals, row_ptr, row_slots, long_rows, n_rows,      \
                           n_long, piece, out, stream);                      \
  }

WINDOWED_SEND_SUM(windowed_send_sum_f32, float, false)
WINDOWED_SEND_SUM(windowed_send_sum_bf16, __nv_bfloat16, true)
