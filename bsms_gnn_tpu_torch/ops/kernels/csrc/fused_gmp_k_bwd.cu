// Kernel 14's backward (see ../fused_gmp_k.py), with the forward recomputed
// in the kernel: kernel 5's function. A thread block cluster of S blocks
// per group of up to S chunks of one output block (the chunks chunk_ptr[b]
// + m·S onward; the cluster of any other chunk returns at once): block m
// walks chunk m of the group (the chunk walk of edge_phase_bwd.cuh, its
// dxj block kept in shared memory, its weight-gradient partial at
// gpart[its chunk]); then, through distributed shared memory, each block
// sums its share of the group's dxj blocks into part[group's first chunk]
// and of the group's partials into gpart[group's first chunk], in chunk
// order. block_sum_kernel (stride S) adds the dxj parts of each output
// block and group_grad_sum_kernel the groups' partials, both in chunk order.
#include <cooperative_groups.h>

#include "block_sum.cuh"
#include "edge_phase_bwd.cuh"

using namespace bsms;
namespace cg = cooperative_groups;

namespace {

constexpr int MAX_STACK = 4;

template <typename T, bool BF16, int S>
__global__ void __cluster_dims__(S, 1, 1) __launch_bounds__(THREADS)
fused_edge_phase_win_k_bwd_kernel(
    const float* __restrict__ fiber_t, const T* __restrict__ xwi,
    const T* __restrict__ xj, const float* __restrict__ wf8,
    const float* __restrict__ W, const float* __restrict__ B,
    const float* __restrict__ WT, const float* __restrict__ g, int n_layers,
    const int* __restrict__ send_win, const int* __restrict__ win_base,
    const int* __restrict__ receivers, const int* __restrict__ chunk_block,
    const int* __restrict__ chunk_ptr, int e_pad, int edge_block, int window,
    float* __restrict__ part, float* __restrict__ gpart,
    T* __restrict__ dpre) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), tid = threadIdx.x;
  const int ch0 = blockIdx.x / S;
  const int blk = chunk_block[ch0];
  // Every block of the cluster reads the same chunk: all return together.
  if ((ch0 - chunk_ptr[blk]) % S) return;
  const int n = min(S, chunk_ptr[blk + 1] - ch0);
  if (rank < n)
    edge_phase_bwd_chunk<T, BF16, Front::kWin>(
        fiber_t, xwi, xj, nullptr, wf8, nullptr, nullptr, 0, W, B, WT, g,
        n_layers, send_win, win_base, receivers, chunk_block, e_pad,
        edge_block, window, part, gpart, dpre, ch0 + rank, false);
  __threadfence();
  cluster.sync();

  constexpr int N4 = BN * C / 4;
  float4* dst = reinterpret_cast<float4*>(part + (size_t)ch0 * BN * C);
  for (int i = rank * N4 / S + tid; i < (rank + 1) * N4 / S; i += THREADS) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int m = 0; m < n; ++m) {
      const float4 v = cluster.map_shared_rank(smem4, m)[i];
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    dst[i] = s;
  }
  // In place: each float4 of the group's partial is read and written by
  // one thread.
  const int size4 = edge_grad_size<Front::kWin>(n_layers, 0) / 4;
  float4* gp = reinterpret_cast<float4*>(gpart);
  for (int i = rank * size4 / S + tid; i < (rank + 1) * size4 / S;
       i += THREADS) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int m = 0; m < n; ++m) {
      const float4 v = gp[(size_t)(ch0 + m) * size4 + i];
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    gp[(size_t)ch0 * size4 + i] = s;
  }
  cluster.sync();  // no block's shared memory goes while another reads it
}

// out[k] = Σ over the groups' first chunks ch, in chunk order, of
// part[ch·size + k]; one float4 per thread.
__global__ void __launch_bounds__(THREADS)
group_grad_sum_kernel(const float* __restrict__ part,
                      const int* __restrict__ chunk_ptr, int n_blocks,
                      int stack, int size4, float* __restrict__ out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= size4) return;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int b = 0; b < n_blocks; ++b) {
    const int c1 = chunk_ptr[b + 1];
    for (int ch = chunk_ptr[b]; ch < c1; ch += stack) {
      const float4 v =
          reinterpret_cast<const float4*>(part + (size_t)ch * size4 * 4)[i];
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
  }
  reinterpret_cast<float4*>(out)[i] = s;
}

template <typename T, bool BF16, int S>
cudaError_t launch_cluster(const void* fiber_t, const void* xwi,
                           const void* xj, const void* wf8, const void* W,
                           const void* B, const void* WT, const void* g,
                           const void* send_win, const void* win_base,
                           const void* receivers, const void* chunk_block,
                           const void* chunk_ptr, int n_layers, int n_chunks,
                           int e_pad, int edge_block, int window, void* part,
                           void* gpart, void* dpre, cudaStream_t stream) {
  auto kernel = fused_edge_phase_win_k_bwd_kernel<T, BF16, S>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)edge_bwd_smem_bytes<false>(MAX_BWD_LAYERS));
  if (attr != cudaSuccess) return attr;
  kernel<<<n_chunks * S, THREADS, edge_bwd_smem_bytes<false>(n_layers),
           stream>>>(
      (const float*)fiber_t, (const T*)xwi, (const T*)xj, (const float*)wf8,
      (const float*)W, (const float*)B, (const float*)WT, (const float*)g,
      n_layers, (const int*)send_win, (const int*)win_base,
      (const int*)receivers, (const int*)chunk_block, (const int*)chunk_ptr,
      e_pad, edge_block, window, (float*)part, (float*)gpart, (T*)dpre);
  return cudaGetLastError();
}

template <typename T, bool BF16>
int launch(const void* fiber_t, const void* xwi, const void* xj,
           const void* wf8, const void* W, const void* B, const void* WT,
           const void* g, const void* send_win, const void* win_base,
           const void* receivers, const void* chunk_block,
           const void* chunk_ptr, int n_layers, int n_chunks, int n_blocks,
           int e_pad, int edge_block, int window, int stack, void* part,
           void* gpart, void* dpre, void* dxj, void* grads, void* stream) {
  if (edge_block % TILE || n_layers < 1 || n_layers > MAX_BWD_LAYERS ||
      stack < 2 || stack > MAX_STACK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  auto go = [&](auto launcher) {
    return launcher(fiber_t, xwi, xj, wf8, W, B, WT, g, send_win, win_base,
                    receivers, chunk_block, chunk_ptr, n_layers, n_chunks,
                    e_pad, edge_block, window, part, gpart, dpre, s);
  };
  cudaError_t err = stack == 2   ? go(launch_cluster<T, BF16, 2>)
                    : stack == 3 ? go(launch_cluster<T, BF16, 3>)
                                 : go(launch_cluster<T, BF16, 4>);
  if (err != cudaSuccess) return (int)err;
  err = launch_block_sum((const float*)part, (const int*)chunk_ptr,
                         (float*)dxj, n_blocks, s, stack);
  if (err != cudaSuccess) return (int)err;
  const int size4 = edge_grad_size<Front::kWin>(n_layers, 0) / 4;
  group_grad_sum_kernel<<<(size4 + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      (const float*)gpart, (const int*)chunk_ptr, n_blocks, stack, size4,
      (float*)grads);
  return (int)cudaGetLastError();
}

}  // namespace

#define FUSED_EDGE_PHASE_WIN_K_BWD(NAME, T, BF16)                             \
  extern "C" int NAME(                                                        \
      const void* fiber_t, const void* xwi, const void* xj, const void* wf8,  \
      const void* W, const void* B, const void* WT, const void* g,            \
      const void* send_win, const void* win_base, const void* receivers,      \
      const void* chunk_block, const void* chunk_ptr, int n_layers,           \
      int n_chunks, int n_blocks, int e_pad, int edge_block, int window,      \
      int stack, void* part, void* gpart, void* dpre, void* dxj, void* grads, \
      void* stream) {                                                         \
    return launch<T, BF16>(fiber_t, xwi, xj, wf8, W, B, WT, g, send_win,      \
                           win_base, receivers, chunk_block, chunk_ptr,       \
                           n_layers, n_chunks, n_blocks, e_pad, edge_block,   \
                           window, stack, part, gpart, dpre, dxj, grads,      \
                           stream);                                           \
  }

FUSED_EDGE_PHASE_WIN_K_BWD(fused_edge_phase_win_k_bwd_f32, float, false)
FUSED_EDGE_PHASE_WIN_K_BWD(fused_edge_phase_win_k_bwd_bf16, __nv_bfloat16,
                           true)
