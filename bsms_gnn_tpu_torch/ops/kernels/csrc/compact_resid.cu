// Kernel 2: the compact residual accumulate (see ../compact_resid.py).
//
//   acc[vb·128 + rl] += vals[cb·128 + j]  for each visit v = (vb, cb) and
//                                         row j with rl = visit_recv[v][j] ≥ 0
//
// In place on acc. One block per 128-row output block: it loads its rows
// of acc, walks its visits [visit_ptr[b], visit_ptr[b+1]) staging each
// visit's value rows in shared memory, adds them one thread per (column,
// half-block) in row order, and writes the rows back. Blocks without a
// visit return at once and keep acc.
#include "common.cuh"

using namespace bsms;

namespace {

constexpr int VROWS = 128;  // compact rows per visit
constexpr size_t SMEM_BYTES =
    sizeof(float) * (BN * C + TILE * C) + sizeof(int) * VROWS;

template <typename T>
__global__ void __launch_bounds__(THREADS)
compact_accum_kernel(const T* __restrict__ vals,
                     const int* __restrict__ visit_cblk,
                     const int* __restrict__ visit_recv,
                     const int* __restrict__ visit_ptr,
                     float* __restrict__ acc_g) {
  const int blk = blockIdx.x;
  const int v0 = visit_ptr[blk], v1 = visit_ptr[blk + 1];
  if (v0 == v1) return;

  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);  // [BN][C] accumulator rows
  float* tile = acc + BN * C;                     // [TILE][C] value rows
  int* s_loc = reinterpret_cast<int*>(tile + TILE * C);  // [VROWS]

  const int tid = threadIdx.x;
  float4* blk_rows = reinterpret_cast<float4*>(acc_g + (size_t)blk * BN * C);
  for (int i = tid; i < BN * C / 4; i += THREADS) smem4[i] = blk_rows[i];

  const int c = tid & (C - 1);
  const int half = tid >> 7;
  for (int v = v0; v < v1; ++v) {
    const size_t row0 = (size_t)visit_cblk[v] * VROWS;
    __syncthreads();  // previous visit is done with s_loc and the tile
    if (tid < VROWS) s_loc[tid] = visit_recv[(size_t)v * VROWS + tid];
    for (int j0 = 0; j0 < VROWS; j0 += TILE) {
      if (j0) __syncthreads();  // previous half's scatter is done
      for (int i = tid; i < TILE * C; i += THREADS)
        tile[i] = to_f(vals[(row0 + j0) * C + i]);
      __syncthreads();
      for (int j = 0; j < TILE; ++j) {
        const int loc = s_loc[j0 + j];
        if (loc >= 0 && (loc >> 6) == half) acc[loc * C + c] += tile[j * C + c];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < BN * C / 4; i += THREADS) blk_rows[i] = smem4[i];
}

template <typename T>
int launch(const void* vals, const void* visit_cblk, const void* visit_recv,
           const void* visit_ptr, void* acc, int n_blocks, void* stream) {
  auto kernel = compact_accum_kernel<T>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<n_blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const T*)vals, (const int*)visit_cblk, (const int*)visit_recv,
      (const int*)visit_ptr, (float*)acc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int compact_accum_f32(const void* vals, const void* visit_cblk,
                                 const void* visit_recv, const void* visit_ptr,
                                 void* acc, int n_blocks, void* stream) {
  return launch<float>(vals, visit_cblk, visit_recv, visit_ptr, acc, n_blocks,
                       stream);
}

extern "C" int compact_accum_bf16(const void* vals, const void* visit_cblk,
                                  const void* visit_recv,
                                  const void* visit_ptr, void* acc,
                                  int n_blocks, void* stream) {
  return launch<__nv_bfloat16>(vals, visit_cblk, visit_recv, visit_ptr, acc,
                               n_blocks, stream);
}
