// The edge phase's first-layer fronts of the tile walks
// (edge_bwd_tiles.cuh's `tile_slots` and `tile_front`, which
// edge_fwd_tiles.cuh shares): kWin (kernels 4, 5 and 14, see
// ../fused_gmp.py and ../fused_gmp_k.py), each slot's sender row, receiver
// and fiber stream and relu(fiber·wf8 + xwi[send] + xj[recv]); kDyn (kernel
// 13, see ../fused_gmp_dyn.py), that plus the dynamic world-space term
// Δ·wf_dyn + ‖Δ‖·wf_nrm; kStream (kernels 11 and 12, see
// ../fused_gmp_stream.py), the first layer's pre-activation streamed from
// device memory, plus, for kernel 12, the receiver's row.
#pragma once

#include "common.cuh"

namespace bsms {

// Widest dynamic (world-space) stream kernel 13 takes.
constexpr int MAX_WD = 4;

// The first-layer front of an edge walk: windowed selection and the fiber
// stream (kernels 4, 5, 14), that plus the world-space fiber (kernel 13),
// or the streamed pre-activation (kernels 11, 12).
enum class Front { kWin, kDyn, kStream };

// Kernel 13's dynamic fiber: the world positions [n_pad][wd] (the
// activations' type), the Δworld rows of the first edge layer [wd][C]
// (rounded in BF16 mode) and its ‖Δworld‖ row [C] (f32: the TPU kernel
// multiplies it in f32) in shared memory, and the tile's Δ = world[send] −
// world[recv] [wd][TR] (rounded in BF16 mode, as the dot operand) and
// ‖Δ‖ [TR] (f32) that the tile walks' `tile_slots` fills in shared memory.
// A batch over the one level keeps each sample's positions p_stride
// elements (n_pad·wd) after the last's: `sample(s)` points at sample s's
// (p_stride 0 at B = 1).
template <typename T>
struct DynFiber {
  const T* pos;
  int wd;
  const float* wfd;
  const float* wfn;
  float* delta;
  float* nrm;
  size_t p_stride;

  __device__ DynFiber sample(int s) const {
    DynFiber d = *this;
    d.pos = pos + s * p_stride;
    return d;
  }
};

}  // namespace bsms
