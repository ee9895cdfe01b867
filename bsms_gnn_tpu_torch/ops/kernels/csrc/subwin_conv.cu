// Kernel 15: the sub-window weighted receiver conv (see ../subwin_conv.py),
// replacing the TPU kernel `benchmarks/v6_prototype.py::_get_v6_conv`:
//
//   out[n] = Σ_{covered e: recv(e)=n} ew_e · x[row_e],
//   row_e = sub_base[chunk, u, j]·128 + send_sub[e] − j·128,  j = send_sub[e] / 128
//
// for slot e in 128-slot sub-chunk u of its chunk; a slot with send_sub[e] ==
// 256 is not covered. What bounds it: bytes, one row read per covered slot
// and the output written once.
//
// Design: kernel 1's (windowed.cu), the row-ordered gather of
// row_gather.cuh over the covered slots whose receiver lies in their
// chunk's block, listed per row in slot order (`sub_row_tables`), with this
// row resolved here from sub_base and send_sub. One launch, no scratch. The
// first design was kernel 1's first one, with its four costs: one
// 134 KB block per SM, a serial shared-memory add per slot, a 64 KB part
// per chunk summed by a second kernel, and a walk over every slot.
#include "row_gather.cuh"

using namespace bsms;

namespace {

constexpr int SUB = 128;  // slots of a sub-chunk, rows of a sender block
constexpr int K = 2;      // sender blocks of a sub-chunk

// The input row of covered slot e, from its sub-chunk's sender blocks.
struct SubRow {
  const int* sub_base;
  const int* send_sub;
  __device__ __forceinline__ int operator()(int e) const {
    const int ss = __ldg(send_sub + e);
    const int j = ss / SUB;
    return __ldg(sub_base + (e / SUB) * K + j) * SUB + ss - j * SUB;
  }
};

template <typename T, bool BF16>
__global__ void __launch_bounds__(THREADS, GATHER_MIN_BLOCKS)
subwin_gather_kernel(const T* __restrict__ x, const float* __restrict__ ew,
                     SubRow row_of, const int* __restrict__ row_ptr,
                     const int* __restrict__ row_slots,
                     const int* __restrict__ long_rows, int n_rows,
                     int piece, float* __restrict__ out) {
  gather_rows<BF16>(x, WeightedSlots<SubRow>{row_slots, ew, row_of},
                    StoreRows{}, row_ptr, long_rows, n_rows, piece, out);
}

template <typename T, bool BF16>
int launch(const void* x, const void* ew, const void* sub_base,
           const void* send_sub, const void* row_ptr, const void* row_slots,
           const void* long_rows, int n_rows, int n_long, int piece,
           void* out, void* stream) {
  if (n_rows < 1 || n_long < 0 || piece < 1) return (int)cudaErrorInvalidValue;
  const SubRow row_of{(const int*)sub_base, (const int*)send_sub};
  subwin_gather_kernel<T, BF16><<<gather_blocks(n_rows, n_long), THREADS, 0,
                                  (cudaStream_t)stream>>>(
      (const T*)x, (const float*)ew, row_of, (const int*)row_ptr,
      (const int*)row_slots, (const int*)long_rows, n_rows, piece,
      (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

#define SUBWIN_CONV(NAME, T, BF16)                                            \
  extern "C" int NAME(const void* x, const void* ew, const void* sub_base,   \
                      const void* send_sub, const void* row_ptr,             \
                      const void* row_slots, const void* long_rows,          \
                      int n_rows, int n_long, int piece, void* out,          \
                      void* stream) {                                        \
    return launch<T, BF16>(x, ew, sub_base, send_sub, row_ptr, row_slots,    \
                           long_rows, n_rows, n_long, piece, out, stream);   \
  }

SUBWIN_CONV(subwin_conv_f32, float, false)
SUBWIN_CONV(subwin_conv_bf16, __nv_bfloat16, true)
