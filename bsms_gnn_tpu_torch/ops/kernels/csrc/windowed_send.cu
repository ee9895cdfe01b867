// Kernel 7: the transposed windowed sum of a level (see ../windowed.py).
//
//   out[n] = Σ_{in-window e: send(e)=n} vals[e],
//   send(e) = win_base[chunk(e)]·W/2 + send_win[e]
//
// The output is indexed by sender windows, and chunks are not sorted by
// window. One block per edge chunk adds each in-window slot's row into a
// shared-memory copy of the chunk's W-row window, one thread per (column,
// row parity), in slot order, and writes it to part[chunk]. A second pass
// gives each W/2-row output block k the matching halves of the parts of
// its (chunk, half) items from the host-built tables send_ptr/send_items
// (the chunks whose window's low half is k, then those whose high half
// is, each group in chunk order), added in that order: deterministic, no
// atomics, and a block no chunk covers comes out zero. Sentinel slots
// (send_win == W) add nothing.
#include "common.cuh"

using namespace bsms;

namespace {

constexpr int UNROLL = 8;
constexpr int MAX_WINDOW = 256;
constexpr int MAX_EDGE_BLOCK = 2048;

constexpr size_t smem_bytes(int window, int edge_block) {
  return sizeof(float) * window * C + sizeof(int) * edge_block;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
windowed_send_part_kernel(const T* __restrict__ vals,
                          const int* __restrict__ send_win, int edge_block,
                          int window, float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);               // [W][C]
  int* s_win = reinterpret_cast<int*>(acc + window * C);      // [edge_block]

  const int tid = threadIdx.x, ch = blockIdx.x;
  const size_t e0 = (size_t)ch * edge_block;
  for (int i = tid; i < window * C; i += THREADS) acc[i] = 0.f;
  for (int i = tid; i < edge_block; i += THREADS) s_win[i] = send_win[e0 + i];
  __syncthreads();

  const int c = tid & (C - 1);
  const int parity = tid >> 7;  // this thread adds the rows of its parity
  for (int j = 0; j < edge_block; j += UNROLL) {
    float v[UNROLL];
    int l[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = s_win[j + u];
      l[u] = (r < window && (r & 1) == parity) ? r : -1;
      v[u] = l[u] >= 0 ? to_f(vals[(e0 + j + u) * C + c]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (l[u] >= 0) acc[l[u] * C + c] += v[u];
  }
  __syncthreads();
  float4* dst = reinterpret_cast<float4*>(part + (size_t)ch * window * C);
  for (int i = tid; i < window * C / 4; i += THREADS) dst[i] = smem4[i];
}

// out[k·W/2 + r][c] = Σ_{items (chunk, half) of k, in order}
// part[chunk][half·W/2 + r][c]. Grid (n_blocks, W/2·C / (4·THREADS)): one
// float4 of the block per thread.
__global__ void __launch_bounds__(THREADS)
windowed_send_sum_kernel(const float* __restrict__ part,
                         const int* __restrict__ send_ptr,
                         const int* __restrict__ send_items, int window,
                         float* __restrict__ out) {
  const int k = blockIdx.x, wh = window / 2;
  const int i = blockIdx.y * THREADS + threadIdx.x;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  const int i1 = send_ptr[k + 1];
  for (int it = send_ptr[k]; it < i1; ++it) {
    const int item = send_items[it];
    const float* src = part + (size_t)(item >> 1) * window * C +
                       (size_t)(item & 1) * wh * C;
    const float4 p = reinterpret_cast<const float4*>(src)[i];
    s.x += p.x; s.y += p.y; s.z += p.z; s.w += p.w;
  }
  reinterpret_cast<float4*>(out + (size_t)k * wh * C)[i] = s;
}

template <typename T>
int launch(const void* vals, const void* send_win, const void* send_ptr,
           const void* send_items, int n_chunks, int n_blocks,
           int edge_block, int window, void* part, void* out, void* stream) {
  const int wh = window / 2;
  if (window > MAX_WINDOW || wh % 8 || wh < 8 || edge_block % UNROLL ||
      edge_block > MAX_EDGE_BLOCK)
    return (int)cudaErrorInvalidValue;
  auto kernel = windowed_send_part_kernel<T>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(MAX_WINDOW, MAX_EDGE_BLOCK));
  if (attr != cudaSuccess) return (int)attr;
  cudaStream_t s = (cudaStream_t)stream;
  kernel<<<n_chunks, THREADS, smem_bytes(window, edge_block), s>>>(
      (const T*)vals, (const int*)send_win, edge_block, window, (float*)part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  windowed_send_sum_kernel<<<dim3(n_blocks, wh * C / (4 * THREADS)), THREADS,
                             0, s>>>((const float*)part, (const int*)send_ptr,
                                     (const int*)send_items, window,
                                     (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

#define WINDOWED_SEND_SUM(NAME, T)                                            \
  extern "C" int NAME(const void* vals, const void* send_win,                \
                      const void* send_ptr, const void* send_items,          \
                      int n_chunks, int n_blocks, int edge_block, int window, \
                      void* part, void* out, void* stream) {                 \
    return launch<T>(vals, send_win, send_ptr, send_items, n_chunks,         \
                     n_blocks, edge_block, window, part, out, stream);       \
  }

WINDOWED_SEND_SUM(windowed_send_sum_f32, float)
WINDOWED_SEND_SUM(windowed_send_sum_bf16, __nv_bfloat16)
