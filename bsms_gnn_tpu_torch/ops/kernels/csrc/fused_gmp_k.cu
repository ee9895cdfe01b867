// Kernel 14: the K-way interleaved windowed fused GMP edge phase (see
// ../fused_gmp_k.py), kernel 4's function:
//
//   out[n] = Σ_{in-window e: recv(e)=n}
//            LN(tail(relu(fiber_t[:, e]ᵀ·wf8 + xwi[send_e] + xj[recv_e])))
//
// One block of NT threads per group of up to S chunks of one output block
// (the chunks chunk_ptr[b] + m·S onward; the block of any other chunk
// returns at once). Step j stacks tile j of each of the group's chunks into
// one [S·64, C] tile, runs the tail MLP and the LayerNorm on it (each
// weight slab staged in shared memory serves the S tiles) and adds its
// rows, in stacked order, into the group's shared-memory output block,
// which goes to part[group's first chunk]; block_sum_kernel (stride S) adds
// the parts of each output block in chunk order.
#include "block_sum.cuh"
#include "edge_tile.cuh"

using namespace bsms;

namespace {

constexpr int NT = 512;  // threads of a block
constexpr int MAX_STACK = 4;

// Floats: the output block, the stacked tile, the weight slab, wf8, the
// fiber stream; then three int tables. S = 4: 228,352 bytes of the 232,448
// a block may have.
template <int S>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BN * C + S * TILE * C + KS * C + 8 * C +
                          8 * S * TILE) +
         sizeof(int) * 3 * S * TILE;
}

__device__ __forceinline__ void fma4(float (&a)[4], float v, float4 w) {
  a[0] = fmaf(v, w.x, a[0]);
  a[1] = fmaf(v, w.y, a[1]);
  a[2] = fmaf(v, w.z, a[2]);
  a[3] = fmaf(v, w.w, a[3]);
}

// tile_gemm's product for an (R·NT/32)×C tile: warp ty owns rows
// R·ty..R·ty+R-1, lane tx columns 4·tx..4·tx+3. Per weight row it holds four
// staged rows and one input float4 (not R of them), which keeps R = 16
// inside the 128 registers a thread of NT = 512 may have; each sum runs over
// k in the same order as tile_gemm's.
template <bool BF16, int R>
__device__ __forceinline__ void stack_gemm(float (&acc)[R][4], const float* in,
                                           const float* __restrict__ W,
                                           float* __restrict__ wslab) {
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  for (int k0 = 0; k0 < C; k0 += KS) {
    __syncthreads();
    const float4* src = reinterpret_cast<const float4*>(W + k0 * C);
    float4* dst = reinterpret_cast<float4*>(wslab);
    for (int i = tid; i < KS * C / 4; i += NT) {
      float4 w = src[i];
      if (BF16) {
        w.x = round_bf16(w.x); w.y = round_bf16(w.y);
        w.z = round_bf16(w.z); w.w = round_bf16(w.w);
      }
      dst[i] = w;
    }
    __syncthreads();
#pragma unroll 1
    for (int k = 0; k < KS; k += 4) {
      float4 w[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        w[kk] = reinterpret_cast<const float4*>(wslab + (k + kk) * C)[tx];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float4 a =
            *reinterpret_cast<const float4*>(in + (R * ty + i) * C + k0 + k);
        fma4(acc[i], a.x, w[0]);
        fma4(acc[i], a.y, w[1]);
        fma4(acc[i], a.z, w[2]);
        fma4(acc[i], a.w, w[3]);
      }
    }
  }
  __syncthreads();
}

// tile_mlp_tail on the stacked tile.
template <bool BF16, int S>
__device__ __forceinline__ void stack_mlp_tail(float* t,
                                               const float* __restrict__ W,
                                               const float* __restrict__ B,
                                               int n_layers, float* wslab) {
  constexpr int R = S * TILE * 32 / NT;
  for (int l = 0; l < n_layers; ++l) {
    float acc[R][4] = {};
    stack_gemm<BF16, R>(acc, t, W + (size_t)l * C * C, wslab);
    const bool last = l == n_layers - 1;
    tile_store(acc, B + l * C, t, !last, BF16 && !last);
  }
  __syncthreads();
  tile_layer_norm<S * TILE, NT>(t);
}

// edge_tile_pre for the stacked tile: row m·64 + r holds slot j + r of chunk
// ch0 + m. Rows of chunks past the group's g select nothing, take a zero
// activation and are masked from the scatter (s_loc = -1). Starts with a
// block barrier.
template <typename T, bool BF16, int S>
__device__ __forceinline__ void stack_tile_pre(
    int j, int ch0, int g, int row0, int e_pad, int edge_block, int window,
    const float* __restrict__ fiber_t, const T* __restrict__ xwi,
    const T* __restrict__ xj, const int* __restrict__ send_win,
    const int* __restrict__ win_base, const int* __restrict__ receivers,
    const float* wf, int* s_row, int* s_recv, int* s_loc, float* fib,
    float* tile) {
  constexpr int ROWS = S * TILE;
  const int tid = threadIdx.x;
  __syncthreads();
  if (tid < ROWS) {
    const int m = tid / TILE;
    s_row[tid] = s_recv[tid] = s_loc[tid] = -1;
    if (m < g) {
      const int ch = ch0 + m, e = ch * edge_block + j + tid % TILE;
      const int sw = send_win[e], r = receivers[e];
      const int loc = r - row0;
      const bool in_win = sw < window;
      s_row[tid] = in_win ? win_base[ch] * (window / 2) + sw : -1;
      s_recv[tid] = r;
      s_loc[tid] = (in_win && loc >= 0 && loc < BN) ? loc : -1;
    }
  }
  for (int i = tid; i < 8 * ROWS; i += NT) {
    const int k = i / ROWS, q = i % ROWS, m = q / TILE;
    const float f =
        m < g ? fiber_t[(size_t)k * e_pad + (ch0 + m) * edge_block + j +
                        q % TILE]
              : 0.f;
    fib[i] = BF16 ? round_bf16(f) : f;
  }
  __syncthreads();
  const int c = tid & (C - 1);
  for (int q = tid >> 7; q < ROWS; q += NT / C) {
    float pre = 0.f;
    if (s_recv[q] >= 0) {
      float f = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) f = fmaf(fib[k * ROWS + q], wf[k * C + c], f);
      const int row = s_row[q];
      const float sel = row >= 0 ? to_f(xwi[(size_t)row * C + c]) : 0.f;
      const float zj = to_f(xj[(size_t)s_recv[q] * C + c]);
      pre = fmaxf((f + sel) + zj, 0.f);
    }
    tile[q * C + c] = BF16 ? round_bf16(pre) : pre;
  }
}

template <typename T, bool BF16, int S>
__global__ void __launch_bounds__(NT)
fused_edge_phase_win_k_kernel(const float* __restrict__ fiber_t,
                              const T* __restrict__ xwi,
                              const T* __restrict__ xj,
                              const float* __restrict__ wf8,
                              const float* __restrict__ W,
                              const float* __restrict__ B, int n_layers,
                              const int* __restrict__ send_win,
                              const int* __restrict__ win_base,
                              const int* __restrict__ receivers,
                              const int* __restrict__ chunk_block,
                              const int* __restrict__ chunk_ptr, int e_pad,
                              int edge_block, int window,
                              float* __restrict__ part) {
  constexpr int ROWS = S * TILE;
  const int tid = threadIdx.x, ch0 = blockIdx.x;
  const int blk = chunk_block[ch0];
  const int first = chunk_ptr[blk];
  if ((ch0 - first) % S) return;  // not the first chunk of a group
  const int g = min(S, chunk_ptr[blk + 1] - ch0);

  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);  // [BN][C] output block
  float* tile = acc + BN * C;                     // [ROWS][C] stacked rows
  float* wslab = tile + ROWS * C;                 // [KS][C] staged weights
  float* wf = wslab + KS * C;                     // [8][C] fiber weights
  float* fib = wf + 8 * C;                        // [8][ROWS] fiber stream
  int* s_row = reinterpret_cast<int*>(fib + 8 * ROWS);
  int* s_recv = s_row + ROWS;
  int* s_loc = s_recv + ROWS;

  const int row0 = blk * BN;
  for (int i = tid; i < BN * C; i += NT) acc[i] = 0.f;
  for (int i = tid; i < 8 * C; i += NT)
    wf[i] = BF16 ? round_bf16(wf8[i]) : wf8[i];

  const int c = tid & (C - 1);
  const int quarter = tid >> 7;  // this thread's 32 rows of the block
  for (int j = 0; j < edge_block; j += TILE) {
    // Starts with a barrier: the previous step's scatter is done.
    stack_tile_pre<T, BF16, S>(j, ch0, g, row0, e_pad, edge_block, window,
                               fiber_t, xwi, xj, send_win, win_base,
                               receivers, wf, s_row, s_recv, s_loc, fib,
                               tile);
    stack_mlp_tail<BF16, S>(tile, W, B, n_layers, wslab);
    for (int q = 0; q < ROWS; ++q) {
      const int loc = s_loc[q];
      if (loc >= 0 && (loc >> 5) == quarter) {
        const float v = tile[q * C + c];
        acc[loc * C + c] += BF16 ? round_bf16(v) : v;
      }
    }
  }
  __syncthreads();
  float4* dst = reinterpret_cast<float4*>(part + (size_t)ch0 * BN * C);
  for (int i = tid; i < BN * C / 4; i += NT) dst[i] = smem4[i];
}

template <typename T, bool BF16, int S>
cudaError_t launch_stack(const void* fiber_t, const void* xwi, const void* xj,
                         const void* wf8, const void* W, const void* B,
                         const void* send_win, const void* win_base,
                         const void* receivers, const void* chunk_block,
                         const void* chunk_ptr, int n_layers, int n_chunks,
                         int e_pad, int edge_block, int window, void* part,
                         cudaStream_t stream) {
  auto kernel = fused_edge_phase_win_k_kernel<T, BF16, S>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<S>());
  if (attr != cudaSuccess) return attr;
  kernel<<<n_chunks, NT, smem_bytes<S>(), stream>>>(
      (const float*)fiber_t, (const T*)xwi, (const T*)xj, (const float*)wf8,
      (const float*)W, (const float*)B, n_layers, (const int*)send_win,
      (const int*)win_base, (const int*)receivers, (const int*)chunk_block,
      (const int*)chunk_ptr, e_pad, edge_block, window, (float*)part);
  return cudaGetLastError();
}

template <typename T, bool BF16>
int launch(const void* fiber_t, const void* xwi, const void* xj,
           const void* wf8, const void* W, const void* B,
           const void* send_win, const void* win_base, const void* receivers,
           const void* chunk_block, const void* chunk_ptr, int n_layers,
           int n_chunks, int n_blocks, int e_pad, int edge_block, int window,
           int stack, void* part, void* out, void* stream) {
  if (edge_block % TILE || stack < 2 || stack > MAX_STACK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  auto go = [&](auto launcher) {
    return launcher(fiber_t, xwi, xj, wf8, W, B, send_win, win_base,
                    receivers, chunk_block, chunk_ptr, n_layers, n_chunks,
                    e_pad, edge_block, window, part, s);
  };
  cudaError_t err = stack == 2   ? go(launch_stack<T, BF16, 2>)
                    : stack == 3 ? go(launch_stack<T, BF16, 3>)
                                 : go(launch_stack<T, BF16, 4>);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_block_sum((const float*)part, (const int*)chunk_ptr,
                               (float*)out, n_blocks, s, stack);
}

}  // namespace

#define FUSED_EDGE_PHASE_WIN_K(NAME, T, BF16)                                 \
  extern "C" int NAME(const void* fiber_t, const void* xwi, const void* xj,  \
                      const void* wf8, const void* W, const void* B,         \
                      const void* send_win, const void* win_base,            \
                      const void* receivers, const void* chunk_block,        \
                      const void* chunk_ptr, int n_layers, int n_chunks,     \
                      int n_blocks, int e_pad, int edge_block, int window,   \
                      int stack, void* part, void* out, void* stream) {      \
    return launch<T, BF16>(fiber_t, xwi, xj, wf8, W, B, send_win, win_base,  \
                           receivers, chunk_block, chunk_ptr, n_layers,      \
                           n_chunks, n_blocks, e_pad, edge_block, window,    \
                           stack, part, out, stream);                        \
  }

FUSED_EDGE_PHASE_WIN_K(fused_edge_phase_win_k_f32, float, false)
FUSED_EDGE_PHASE_WIN_K(fused_edge_phase_win_k_bf16, __nv_bfloat16, true)
