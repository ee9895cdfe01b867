// Kernel 1: the windowed conv, in its rect form (a windowed TransOp's
// application, x in the operator's input space) and its level form (a
// level's own edges, x in the level's node space, ew the level's `ew` or
// `ew_rev`); see ../windowed.py. It replaces the TPU kernel
// `bsms_gnn_tpu/ops/pallas/windowed.py::_get_call` (`_make_kernel`). Both
// forms are one function, behind one entry point per dtype:
//
//   out[k] = Σ_{in-window e: recv(e)=k} ew_e · x[win_base[chunk]·W/2 + send_win[e]]
//
// What bounds it: bytes. Each live slot reads one 512-byte row (256 in
// bf16) for 256 FLOP, and at the 5k mesh a launch moves a few MB, so there
// the latency of one launch is its time.
//
// Design: the row-ordered gather of row_gather.cuh over the layout's
// live-slot lists (`win_row_ptr`, `win_row_slots`: the slots with send_win
// < W whose receiver lies in their chunk's block, in slot order) and its
// rows of more than 32 of them (`win_long`). Each slot's row is resolved
// here, from send_win and win_base, as the TPU kernel selects it. One
// launch, no scratch.
//
// The first design gave each edge chunk a thread block that added
// ew·x[row] into two shared-memory copies of the chunk's 128-row output
// block (134 KB, so one block of 8 warps per SM), one thread per column in
// slot order: a chunk is sorted by sender, so consecutive slots land on
// scattered rows and each slot was a serial read-modify-write of shared
// memory with 4-byte loads; each chunk wrote a 64 KB part that a second
// kernel read back (1 GB each way on a 1M-node level), and sentinel slots
// were walked too. It was 4.5x slower than `torch.sparse.mm` there.
#include "row_gather.cuh"

using namespace bsms;

namespace {

// The input row of live slot e: its chunk's window base plus its offset.
struct WindowRow {
  const int* send_win;
  const int* win_base;
  int edge_block, half;
  __device__ __forceinline__ int operator()(int e) const {
    return __ldg(win_base + e / edge_block) * half + __ldg(send_win + e);
  }
};

template <typename T, bool BF16>
__global__ void __launch_bounds__(THREADS, GATHER_MIN_BLOCKS)
windowed_gather_kernel(const T* __restrict__ x, const float* __restrict__ ew,
                       WindowRow row_of, const int* __restrict__ row_ptr,
                       const int* __restrict__ row_slots,
                       const int* __restrict__ long_rows, int n_rows,
                       int piece, float* __restrict__ out) {
  gather_rows<BF16>(x, WeightedSlots<WindowRow>{row_slots, ew, row_of},
                    StoreRows{}, row_ptr, long_rows, n_rows, piece, out);
}

template <typename T, bool BF16>
int launch(const void* x, const void* ew, const void* send_win,
           const void* win_base, const void* row_ptr, const void* row_slots,
           const void* long_rows, int n_rows, int n_long, int edge_block,
           int window, int piece, void* out, void* stream) {
  if (n_rows < 1 || n_long < 0 || piece < 1 || edge_block < 1 || window < 2)
    return (int)cudaErrorInvalidValue;
  const WindowRow row_of{(const int*)send_win, (const int*)win_base,
                         edge_block, window / 2};
  windowed_gather_kernel<T, BF16><<<gather_blocks(n_rows, n_long), THREADS,
                                    0, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)ew, row_of, (const int*)row_ptr,
      (const int*)row_slots, (const int*)long_rows, n_rows, piece,
      (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

#define WINDOWED_CONV(NAME, T, BF16)                                          \
  extern "C" int NAME(const void* x, const void* ew, const void* send_win,   \
                      const void* win_base, const void* row_ptr,             \
                      const void* row_slots, const void* long_rows,          \
                      int n_rows, int n_long, int edge_block, int window,    \
                      int piece, void* out, void* stream) {                  \
    return launch<T, BF16>(x, ew, send_win, win_base, row_ptr, row_slots,    \
                           long_rows, n_rows, n_long, edge_block, window,    \
                           piece, out, stream);                              \
  }

WINDOWED_CONV(windowed_conv_f32, float, false)
WINDOWED_CONV(windowed_conv_bf16, __nv_bfloat16, true)
