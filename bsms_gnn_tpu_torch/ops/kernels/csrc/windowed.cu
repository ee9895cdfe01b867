// Kernel 1: the windowed conv, in its rect form (a windowed TransOp's
// application, x in the operator's input space) and its level form (a
// level's own edges, x in the level's node space, ew the level's `ew` or
// `ew_rev`); see ../windowed.py. Both forms are one function, behind one
// entry point per dtype:
//
//   out[k] = Σ_{in-window e: recv(e)=k} ew_e · x[win_base[chunk]·W/2 + send_win[e]]
//
// One block per edge chunk: each half of its threads takes half of the
// chunk's slots and adds ew·x[row] into its own shared-memory copy of the
// chunk's 128-row output block, one thread per column, in slot order (the
// row loads of eight slots are issued before their adds); the two copies
// are summed into part[chunk], and block_sum_kernel adds the parts of each
// output block in chunk order.
#include "block_sum.cuh"

using namespace bsms;

namespace {

constexpr int MAX_EDGE_BLOCK = 2048;
constexpr int UNROLL = 8;

constexpr size_t smem_bytes(int edge_block) {
  return sizeof(float) * 2 * BN * C + 3 * sizeof(int) * edge_block;
}

template <typename T, bool BF16>
__global__ void __launch_bounds__(THREADS)
windowed_conv_kernel(const T* __restrict__ x, const float* __restrict__ ew,
                     const int* __restrict__ send_win,
                     const int* __restrict__ win_base,
                     const int* __restrict__ receivers,
                     const int* __restrict__ chunk_block, int edge_block,
                     int window, float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  float* acc0 = reinterpret_cast<float*>(smem4);  // [BN][C], first half
  float* acc1 = acc0 + BN * C;                     // [BN][C], second half
  int* s_row = reinterpret_cast<int*>(acc1 + BN * C);  // input row or -1
  int* s_loc = s_row + edge_block;                     // local output row
  float* s_w = reinterpret_cast<float*>(s_loc + edge_block);  // weight

  const int tid = threadIdx.x, ch = blockIdx.x;
  const int base = win_base[ch] * (window / 2);
  const int row0 = chunk_block[ch] * BN;
  for (int i = tid; i < 2 * BN * C; i += THREADS) acc0[i] = 0.f;
  for (int i = tid; i < edge_block; i += THREADS) {
    const int e = ch * edge_block + i;
    const int sw = send_win[e];
    const int loc = receivers[e] - row0;
    const bool live = sw < window && loc >= 0 && loc < BN;
    s_row[i] = live ? base + sw : -1;
    s_loc[i] = loc;
    s_w[i] = BF16 ? round_bf16(ew[e]) : ew[e];
  }
  __syncthreads();

  const int c = tid & (C - 1);
  const int half = tid >> 7;
  float* acc = half ? acc1 : acc0;
  const int n = edge_block / 2, s0 = half * n;
  for (int j = 0; j < n; j += UNROLL) {
    float v[UNROLL];
    int l[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int s = s0 + j + u;
      const int row = s_row[s];
      l[u] = row >= 0 ? s_loc[s] : -1;
      v[u] = row >= 0 ? s_w[s] * to_f(x[(size_t)row * C + c]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (l[u] >= 0) acc[l[u] * C + c] += v[u];
  }
  __syncthreads();
  const float4* a0 = smem4;
  const float4* a1 = smem4 + BN * C / 4;
  float4* dst = reinterpret_cast<float4*>(part + (size_t)ch * BN * C);
  for (int i = tid; i < BN * C / 4; i += THREADS) {
    const float4 p = a0[i], q = a1[i];
    dst[i] = make_float4(p.x + q.x, p.y + q.y, p.z + q.z, p.w + q.w);
  }
}

template <typename T, bool BF16>
int launch(const void* x, const void* ew, const void* send_win,
           const void* win_base, const void* receivers,
           const void* chunk_block, const void* chunk_ptr, int n_chunks,
           int n_blocks, int edge_block, int window, void* part, void* out,
           void* stream) {
  if (edge_block % (2 * UNROLL) || edge_block > MAX_EDGE_BLOCK)
    return (int)cudaErrorInvalidValue;
  auto kernel = windowed_conv_kernel<T, BF16>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(MAX_EDGE_BLOCK));
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<n_chunks, THREADS, smem_bytes(edge_block), (cudaStream_t)stream>>>(
      (const T*)x, (const float*)ew, (const int*)send_win,
      (const int*)win_base, (const int*)receivers, (const int*)chunk_block,
      edge_block, window, (float*)part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_block_sum((const float*)part, (const int*)chunk_ptr,
                               (float*)out, n_blocks, (cudaStream_t)stream);
}

}  // namespace

#define WINDOWED_CONV(NAME, T, BF16)                                          \
  extern "C" int NAME(const void* x, const void* ew, const void* send_win,   \
                      const void* win_base, const void* receivers,           \
                      const void* chunk_block, const void* chunk_ptr,        \
                      int n_chunks, int n_blocks, int edge_block, int window, \
                      void* part, void* out, void* stream) {                 \
    return launch<T, BF16>(x, ew, send_win, win_base, receivers, chunk_block, \
                           chunk_ptr, n_chunks, n_blocks, edge_block, window, \
                           part, out, stream);                               \
  }

WINDOWED_CONV(windowed_conv_f32, float, false)
WINDOWED_CONV(windowed_conv_bf16, __nv_bfloat16, true)
