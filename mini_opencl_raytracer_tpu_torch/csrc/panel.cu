// Panel intersection kernel for Hopper (sm_90a): dense closest hit and
// any-hit of rays against every triangle of a small scene.
//
// Replaces mini_opencl_raytracer_tpu/ops/pallas/panel.py:_panel_kernel (K5),
// the intersector of the wavefront `pallas` backend for scenes of at most
// FLAT_PANEL_MAX_TRIS = 2048 triangles. The TPU kernel laid triangles on
// sublanes and 128 rays on lanes and ran Moller-Trumbore as [512, 128]
// vector panels with a masked-iota argmin; here each ray is a thread.
//
// Semantics (ops/cuda/panel.run_panel_plain): closest mode returns, per
// ray, the smallest t with 0 < t < t_init over all records and its index
// (-1 on a miss, t = t_init); among equal t the lowest index wins, as the
// strict '<' over records in index order gives. Any mode returns an index
// of some record with 0 < t < t_init (-1 if none), stopping at the first.
//
// What bounds it on this card: operations. Every ray runs the ~45-flop
// Moller-Trumbore test against every triangle (Cornell: 36, up to 2048),
// while it moves 36 bytes of its own (o, d, t_init in; t, idx out).
//
// What the design does about it:
//   * one thread per ray, 256 per block, the ragged tail masked;
//   * the (v0, e1, e2) records (36 bytes each) are staged in shared memory
//     in tiles of kTile triangles, so the inner loop reads broadcast
//     shared memory and a 2048-triangle scene needs 18 KB, not 72 KB;
//   * the test exits at the first failed condition, and any mode stops a
//     ray at its first occluder.
// Built with -fmad=false and in the plain version's operation order, so t
// and the winner match the plain version bit for bit.

#include "traverse.cuh"

namespace {

constexpr int kTile = 512;

template <bool kAny>
__global__ void __launch_bounds__(kBlock)
panel_kernel(int R, int T, int cull, const float* __restrict__ tris, const float* __restrict__ o,
             const float* __restrict__ d, const float* __restrict__ t_init, float* t_out,
             int* idx_out) {
  __shared__ float s_tris[kTile * kTriCols];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < R;
  V3 ro = mk(0.0f, 0.0f, 0.0f), rd = ro;
  float best = 0.0f;
  if (live) {
    ro = ld3(o + 3 * (size_t)i);
    rd = ld3(d + 3 * (size_t)i);
    best = t_init[i];
  }
  int bi = -1;
  bool done = !live;
  for (int base = 0; base < T; base += kTile) {
    const int n = min(kTile, T - base);
    __syncthreads();  // every thread is done with the previous tile
    for (int k = threadIdx.x; k < n * kTriCols; k += blockDim.x)
      s_tris[k] = tris[(size_t)base * kTriCols + k];
    __syncthreads();
    if (done) continue;
    for (int k = 0; k < n; ++k) {
      float t;
      if (mt_hit(ro, rd, s_tris + kTriCols * k, cull != 0, t) && t < best) {
        best = t;
        bi = base + k;
        if (kAny) {
          done = true;
          break;
        }
      }
    }
  }
  if (live) {
    t_out[i] = best;
    idx_out[i] = bi;
  }
}

}  // namespace

// C entry point (bound with ctypes by ops/cuda/build.py): launches on the
// given stream, does not synchronise, returns the launch's cudaError_t.
extern "C" int mrt_panel(int R, int T, int cull, int any, const float* tris, const float* o,
                         const float* d, const float* t_init, float* t_out, int* idx_out,
                         void* stream) {
  if (R <= 0) return 0;
  const int grid = (R + kBlock - 1) / kBlock;
  if (any)
    panel_kernel<true><<<grid, kBlock, 0, (cudaStream_t)stream>>>(R, T, cull, tris, o, d, t_init,
                                                                   t_out, idx_out);
  else
    panel_kernel<false><<<grid, kBlock, 0, (cudaStream_t)stream>>>(R, T, cull, tris, o, d, t_init,
                                                                    t_out, idx_out);
  return (int)cudaGetLastError();
}
