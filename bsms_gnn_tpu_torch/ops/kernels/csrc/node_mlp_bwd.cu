// Kernel 6: the backward of the fused GMP node phase (see ../node_mlp.py),
// with the forward recomputed in the kernel.
//
// For out = LN(tail(relu(x·Wa + aggr·Wb + b0))) + x and its cotangent g:
//   dx = dpre·Waᵀ + g,  daggr = dpre·Wbᵀ              (per row)
//   dWa = xᵀ·dpre, dWb = aggrᵀ·dpre, db0 = Σ dpre, dW[l], db[l]
//
// One block per 64-row tile keeps every tail layer's input and the running
// cotangent in shared memory, and writes its weight gradients as its own
// partial; grad_sum_kernel adds the partials in tile order (no atomics).
#include "backward.cuh"

using namespace bsms;

namespace {

constexpr int MAX_LAYERS = 3;

size_t smem_bytes(int n_layers) {
  return sizeof(float) * ((size_t)(n_layers + 1) * TILE * C + KS * C + TILE);
}

// One TILE×C tile of a row-major [n, C] array into shared memory, rounded
// to bf16 in BF16 mode (as a dot operand).
template <typename T, bool BF16>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, float* dst) {
  for (int i = threadIdx.x; i < TILE * C; i += THREADS) {
    const float v = to_f(src[i]);
    dst[i] = BF16 ? round_bf16(v) : v;
  }
}

// TX: x's type (dx is stored in it).
template <typename TX, bool BF16>
__global__ void __launch_bounds__(THREADS)
fused_node_phase_bwd_kernel(const TX* __restrict__ x,
                            const float* __restrict__ aggr,
                            const float* __restrict__ W0,
                            const float* __restrict__ b0,
                            const float* __restrict__ W,
                            const float* __restrict__ B,
                            const float* __restrict__ WabT,
                            const float* __restrict__ WT,
                            const float* __restrict__ g, int n_layers,
                            TX* __restrict__ dx, float* __restrict__ daggr,
                            float* __restrict__ gpart) {
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);  // [n_layers][TILE][C]
  float* d = hs + (size_t)n_layers * TILE * C;  // [TILE][C] LN out, cotangent
  float* wslab = d + TILE * C;                  // [KS][C] staged weights
  float* inv = wslab + KS * C;                  // [TILE] LN 1/std

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row0 = (size_t)blockIdx.x * TILE;
  const size_t cc = (size_t)C * C;
  // Partial layout: dWa, dWb, dW[n_layers], db0, db[n_layers].
  float* gp = gpart + blockIdx.x * ((2 + n_layers) * cc + (1 + n_layers) * C);
  float* gp_b0 = gp + (2 + n_layers) * cc;
  const TX* xt = x + row0 * C;
  const float* at = aggr + row0 * C;

  // Recompute as kernel 3 does: relu(x·Wa + aggr·Wb + b0) into hs[0].
  {
    float acc[8][4] = {};
    load_tile<TX, BF16>(xt, hs);
    tile_gemm<BF16>(acc, hs, W0, wslab);
    load_tile<float, BF16>(at, d);
    tile_gemm<BF16>(acc, d, W0 + cc, wslab);
    tile_store(acc, b0, hs, true, BF16);
  }
  tile_mlp_tail_save<BF16>(hs, d, inv, W, B, n_layers, wslab);

  // LayerNorm backward of g (f32, as on the TPU).
  for (int r = warp; r < TILE; r += THREADS / 32) {
    const float4 gv = reinterpret_cast<const float4*>(g + (row0 + r) * C)[lane];
    float4* dp = reinterpret_cast<float4*>(d + r * C) + lane;
    *dp = ln_bwd(gv, *dp, inv[r]);
  }

  // Tail layers in reverse, as kernel 5 does.
  for (int l = n_layers - 1; l >= 0; --l) {
    const float* h = hs + (size_t)l * TILE * C;
    __syncthreads();
    if (tid < C) gp_b0[C + l * C + tid] = tile_colsum(d);
    if (BF16) tile_round_bf16(d);
    __syncthreads();
    float dw[8][8] = {};
    tile_gemm_tn(dw, h, d);
    store_tn(dw, gp + (2 + l) * cc, false);
    float dh[8][4] = {};
    tile_gemm<BF16>(dh, d, WT + l * cc, wslab);
    tile_store_masked(dh, h, d);
  }

  // d is dpre: db0 from it unrounded, then the rounded operand of the rest.
  __syncthreads();
  if (tid < C) gp_b0[tid] = tile_colsum(d);
  if (BF16) tile_round_bf16(d);
  const int tx = lane, ty = warp;
  {
    float acc[8][4] = {};
    tile_gemm<BF16>(acc, d, WabT, wslab);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const size_t o = (row0 + 8 * ty + i) * C + 4 * tx;
      const float4 gv = *reinterpret_cast<const float4*>(g + o);
      store(&dx[o], acc[i][0] + gv.x);
      store(&dx[o + 1], acc[i][1] + gv.y);
      store(&dx[o + 2], acc[i][2] + gv.z);
      store(&dx[o + 3], acc[i][3] + gv.w);
    }
  }
  {
    float acc[8][4] = {};
    tile_gemm<BF16>(acc, d, WabT + cc, wslab);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const size_t o = (row0 + 8 * ty + i) * C + 4 * tx;
      *reinterpret_cast<float4*>(daggr + o) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
  // dWa and dWb: x, then aggr, in hs[0] (free now) as the left operand.
  {
    float dw[8][8] = {};
    load_tile<TX, BF16>(xt, hs);
    __syncthreads();
    tile_gemm_tn(dw, hs, d);
    store_tn(dw, gp, false);
  }
  __syncthreads();
  {
    float dw[8][8] = {};
    load_tile<float, BF16>(at, hs);
    __syncthreads();
    tile_gemm_tn(dw, hs, d);
    store_tn(dw, gp + cc, false);
  }
}

template <typename TX, bool BF16>
int launch(const void* x, const void* aggr, const void* W0, const void* b0,
           const void* W, const void* B, const void* WabT, const void* WT,
           const void* g, void* gpart, int n_layers, int n_tiles, void* dx,
           void* daggr, void* grads, void* stream) {
  if (n_layers < 1 || n_layers > MAX_LAYERS) return (int)cudaErrorInvalidValue;
  auto kernel = fused_node_phase_bwd_kernel<TX, BF16>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(MAX_LAYERS));
  if (attr != cudaSuccess) return (int)attr;
  cudaStream_t s = (cudaStream_t)stream;
  kernel<<<n_tiles, THREADS, smem_bytes(n_layers), s>>>(
      (const TX*)x, (const float*)aggr, (const float*)W0, (const float*)b0,
      (const float*)W, (const float*)B, (const float*)WabT, (const float*)WT,
      (const float*)g, n_layers, (TX*)dx, (float*)daggr, (float*)gpart);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int size = (2 + n_layers) * C * C + (1 + n_layers) * C;
  return (int)launch_grad_sum((const float*)gpart, n_tiles, size,
                              (float*)grads, s);
}

}  // namespace

#define FUSED_NODE_PHASE_BWD(NAME, TX, BF16)                                   \
  extern "C" int NAME(const void* x, const void* aggr, const void* W0,        \
                      const void* b0, const void* W, const void* B,           \
                      const void* WabT, const void* WT, const void* g,        \
                      void* gpart, int n_layers, int n_tiles, void* dx,       \
                      void* daggr, void* grads, void* stream) {               \
    return launch<TX, BF16>(x, aggr, W0, b0, W, B, WabT, WT, g, gpart,        \
                            n_layers, n_tiles, dx, daggr, grads, stream);     \
  }

// f32 compute; bf16 compute on bf16 x; bf16 compute on f32 x (as kernel 3).
FUSED_NODE_PHASE_BWD(fused_node_phase_bwd_f32, float, false)
FUSED_NODE_PHASE_BWD(fused_node_phase_bwd_bf16, __nv_bfloat16, true)
FUSED_NODE_PHASE_BWD(fused_node_phase_bwd_f32_bf16, float, true)
