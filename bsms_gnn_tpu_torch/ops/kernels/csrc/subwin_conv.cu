// Kernel 15: the sub-window weighted receiver conv (see ../subwin_conv.py):
//
//   out[n] = Σ_{covered e: recv(e)=n} ew_e · x[row_e],
//   row_e = sub_base[chunk, u, j]·128 + send_sub[e] − j·128,  j = send_sub[e] / 128
//
// for slot e in 128-slot sub-chunk u of its chunk; a slot with send_sub[e] ==
// 256 is not covered. Kernel 1's scheme (windowed.cu) with this row: one
// block per edge chunk; each half of its threads takes half of the chunk's
// slots and adds ew·x[row] into its own shared-memory copy of the chunk's
// 128-row output block, one thread per column, in slot order (the row loads
// of eight slots issued before their adds); the two copies are summed into
// part[chunk], and block_sum_kernel adds the parts of each output block in
// chunk order.
#include "block_sum.cuh"

using namespace bsms;

namespace {

constexpr int SUB = 128;  // slots of a sub-chunk, rows of a sender block
constexpr int K = 2;      // sender blocks of a sub-chunk
constexpr int MAX_EDGE_BLOCK = 2048;
constexpr int UNROLL = 8;

constexpr size_t smem_bytes(int edge_block) {
  return sizeof(float) * 2 * BN * C + 3 * sizeof(int) * edge_block;
}

template <typename T, bool BF16>
__global__ void __launch_bounds__(THREADS)
subwin_conv_kernel(const T* __restrict__ x, const float* __restrict__ ew,
                   const int* __restrict__ sub_base,
                   const int* __restrict__ send_sub,
                   const int* __restrict__ receivers,
                   const int* __restrict__ chunk_block, int edge_block,
                   float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  float* acc0 = reinterpret_cast<float*>(smem4);  // [BN][C], first half
  float* acc1 = acc0 + BN * C;                     // [BN][C], second half
  int* s_row = reinterpret_cast<int*>(acc1 + BN * C);  // input row or -1
  int* s_loc = s_row + edge_block;                     // local output row
  float* s_w = reinterpret_cast<float*>(s_loc + edge_block);  // weight

  const int tid = threadIdx.x, ch = blockIdx.x;
  const int row0 = chunk_block[ch] * BN;
  const int subs = edge_block / SUB;
  for (int i = tid; i < 2 * BN * C; i += THREADS) acc0[i] = 0.f;
  for (int i = tid; i < edge_block; i += THREADS) {
    const int e = ch * edge_block + i;
    const int ss = send_sub[e];
    const int loc = receivers[e] - row0;
    const bool live = ss < K * SUB && loc >= 0 && loc < BN;
    const int j = ss / SUB;
    s_row[i] = live ? sub_base[(ch * subs + i / SUB) * K + j] * SUB + ss - j * SUB
                    : -1;
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
int launch(const void* x, const void* ew, const void* sub_base,
           const void* send_sub, const void* receivers,
           const void* chunk_block, const void* chunk_ptr, int n_chunks,
           int n_blocks, int edge_block, void* part, void* out,
           void* stream) {
  if (edge_block % SUB || edge_block > MAX_EDGE_BLOCK)
    return (int)cudaErrorInvalidValue;
  auto kernel = subwin_conv_kernel<T, BF16>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(MAX_EDGE_BLOCK));
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<n_chunks, THREADS, smem_bytes(edge_block), (cudaStream_t)stream>>>(
      (const T*)x, (const float*)ew, (const int*)sub_base,
      (const int*)send_sub, (const int*)receivers, (const int*)chunk_block,
      edge_block, (float*)part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_block_sum((const float*)part, (const int*)chunk_ptr,
                               (float*)out, n_blocks, (cudaStream_t)stream);
}

}  // namespace

#define SUBWIN_CONV(NAME, T, BF16)                                            \
  extern "C" int NAME(const void* x, const void* ew, const void* sub_base,   \
                      const void* send_sub, const void* receivers,           \
                      const void* chunk_block, const void* chunk_ptr,        \
                      int n_chunks, int n_blocks, int edge_block, void* part, \
                      void* out, void* stream) {                             \
    return launch<T, BF16>(x, ew, sub_base, send_sub, receivers, chunk_block, \
                           chunk_ptr, n_chunks, n_blocks, edge_block, part,  \
                           out, stream);                                     \
  }

SUBWIN_CONV(subwin_conv_f32, float, false)
SUBWIN_CONV(subwin_conv_bf16, __nv_bfloat16, true)
