// Kernel 4: the windowed fused GMP edge phase (see ../fused_gmp.py).
//
//   out[n] = Σ_{in-window e: recv(e)=n}
//            LN(tail(relu(fiber_t[:, e]ᵀ·wf8 + xwi[send_e] + xj[recv_e])))
//
// One block per edge chunk: it walks the chunk in 64-slot tiles and adds
// each tile into a shared-memory copy of the chunk's 128-row output block,
// one thread per (column, half-block), in slot order; the block is written
// to part[chunk]. block_sum_kernel then adds the parts of each output block
// in chunk order.
#include "block_sum.cuh"
#include "edge_tile.cuh"

using namespace bsms;

namespace {

constexpr size_t SMEM_BYTES =
    sizeof(float) * (BN * C + TILE * C + KS * C + 8 * C + 8 * TILE) +
    sizeof(int) * 3 * TILE;

template <typename T, bool BF16>
__global__ void __launch_bounds__(THREADS)
fused_edge_phase_win_kernel(const float* __restrict__ fiber_t,
                            const T* __restrict__ xwi,
                            const T* __restrict__ xj,
                            const float* __restrict__ wf8,
                            const float* __restrict__ W,
                            const float* __restrict__ B, int n_layers,
                            const int* __restrict__ send_win,
                            const int* __restrict__ win_base,
                            const int* __restrict__ receivers,
                            const int* __restrict__ chunk_block, int e_pad,
                            int edge_block, int window,
                            float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);  // [BN][C] output block
  float* tile = acc + BN * C;                     // [TILE][C] edge rows
  float* wslab = tile + TILE * C;                 // [KS][C] staged weights
  float* wf = wslab + KS * C;                     // [8][C] fiber weights
  float* fib = wf + 8 * C;                        // [8][TILE] fiber stream
  int* s_row = reinterpret_cast<int*>(fib + 8 * TILE);  // sender row or -1
  int* s_recv = s_row + TILE;                           // receiver row
  int* s_loc = s_recv + TILE;  // local output row, -1 = masked from scatter

  const int tid = threadIdx.x, ch = blockIdx.x;
  const int base = win_base[ch] * (window / 2);
  const int row0 = chunk_block[ch] * BN;
  for (int i = tid; i < BN * C; i += THREADS) acc[i] = 0.f;
  for (int i = tid; i < 8 * C; i += THREADS)
    wf[i] = BF16 ? round_bf16(wf8[i]) : wf8[i];

  const int c = tid & (C - 1);  // column of the scatter step
  const int half = tid >> 7;    // which half of the rows this thread takes
  const EdgeSlots slots{s_row, s_recv, s_loc, fib};
  for (int t0 = ch * edge_block; t0 < (ch + 1) * edge_block; t0 += TILE) {
    // Starts with a barrier: the previous tile's scatter is done.
    edge_tile_pre<T, BF16>(t0, base, row0, e_pad, window, fiber_t, xwi, xj,
                           send_win, receivers, wf, slots, tile);
    tile_mlp_tail<BF16>(tile, W, B, n_layers, wslab);
    for (int r = 0; r < TILE; ++r) {
      const int loc = s_loc[r];
      if (loc >= 0 && (loc >> 6) == half) {
        const float v = tile[r * C + c];
        acc[loc * C + c] += BF16 ? round_bf16(v) : v;
      }
    }
  }
  __syncthreads();
  float4* dst = reinterpret_cast<float4*>(part + (size_t)ch * BN * C);
  for (int i = tid; i < BN * C / 4; i += THREADS) dst[i] = smem4[i];
}

template <typename T, bool BF16>
int launch(const void* fiber_t, const void* xwi, const void* xj,
           const void* wf8, const void* W, const void* B,
           const void* send_win, const void* win_base, const void* receivers,
           const void* chunk_block, const void* chunk_ptr, int n_layers,
           int n_chunks, int n_blocks, int e_pad, int edge_block, int window,
           void* part, void* out, void* stream) {
  if (edge_block % TILE) return (int)cudaErrorInvalidValue;
  auto kernel = fused_edge_phase_win_kernel<T, BF16>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<n_chunks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const float*)fiber_t, (const T*)xwi, (const T*)xj, (const float*)wf8,
      (const float*)W, (const float*)B, n_layers, (const int*)send_win,
      (const int*)win_base, (const int*)receivers, (const int*)chunk_block,
      e_pad, edge_block, window, (float*)part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_block_sum((const float*)part, (const int*)chunk_ptr,
                               (float*)out, n_blocks, (cudaStream_t)stream);
}

}  // namespace

#define FUSED_EDGE_PHASE_WIN(NAME, T, BF16)                                   \
  extern "C" int NAME(const void* fiber_t, const void* xwi, const void* xj,  \
                      const void* wf8, const void* W, const void* B,         \
                      const void* send_win, const void* win_base,            \
                      const void* receivers, const void* chunk_block,        \
                      const void* chunk_ptr, int n_layers, int n_chunks,     \
                      int n_blocks, int e_pad, int edge_block, int window,   \
                      void* part, void* out, void* stream) {                 \
    return launch<T, BF16>(fiber_t, xwi, xj, wf8, W, B, send_win, win_base,  \
                           receivers, chunk_block, chunk_ptr, n_layers,      \
                           n_chunks, n_blocks, e_pad, edge_block, window,    \
                           part, out, stream);                               \
  }

FUSED_EDGE_PHASE_WIN(fused_edge_phase_win_f32, float, false)
FUSED_EDGE_PHASE_WIN(fused_edge_phase_win_bf16, __nv_bfloat16, true)
