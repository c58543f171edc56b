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
// What bounds it on this card: operations. Without a cull every ray runs
// the ~45-flop Moller-Trumbore test against every triangle (Cornell: 36 of
// 40 padded records, up to 2048), ~92 instructions a test under
// -fmad=false, while it moves 36 bytes of its own (o, d, t_init in; t, idx
// out). But nearly all of those tests fail: a warp of 32 coherent rays
// meets ~1 of Cornell's 36 triangles.
//
// What the design does about it:
//   * one thread per ray, 256 per block, the ragged tail masked;
//   * the (v0, e1, e2) records (36 bytes each) are staged in shared memory
//     in tiles of kTile triangles, so the inner loop reads broadcast
//     shared memory and a 2048-triangle scene needs 18 KB, not 72 KB;
//   * per warp, a conservative cull of each tile's records against the
//     bundle of the warp's rays (bundle.cuh): 32 records a round, one per
//     lane, then a ballot; the exact test runs only over the records the
//     cull keeps, in ascending index order, taken from the ballot's mask.
//     A warp whose directions straddle 0 on two axes runs the dense
//     loop over every record;
//   * the test exits at the first failed condition, and any mode stops a
//     ray at its first occluder (a warp stops when all its rays have).
// Built with -fmad=false and in the plain version's operation order, so t
// and the winner match the plain version bit for bit: the cull only drops
// records that the exact test rejects. The optional per-ray counts (stats)
// are the M-T tests a ray ran; ops/cuda/bundle_cull.py models them.

#include "bundle.cuh"
#include "traverse.cuh"

namespace {

constexpr int kTile = 512;

// One exact test of record ``tr`` (index k): the closest hit so far
// updated; true where any mode is done.
template <bool kAny>
__device__ __forceinline__ bool test_record(V3 ro, V3 rd, const float* tr, bool cull, int k,
                                            float& best, int& bi) {
  float t;
  if (!(mt_hit(ro, rd, tr, cull, t) && t < best)) return false;
  best = t;
  bi = k;
  return kAny;
}

template <bool kAny>
__global__ void __launch_bounds__(kBlock)
panel_kernel(int R, int T, int cull, const float* __restrict__ tris, const float* __restrict__ o,
             const float* __restrict__ d, const float* __restrict__ t_init, float* t_out,
             int* idx_out, int* stats) {
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
  // The warp's kind first; a culled warp takes its bundle per tile (its
  // limit read again from t_init), so that nothing of it stays live through
  // a dense warp's loop, which walks the tile by pointer (with more live
  // registers the compiler recomputed each record's shared-memory address
  // inside that loop).
  bool dense, empty;
  bundle_kind(live, takes_part(live, ro, rd), rd, dense, empty);
  int bi = -1, tests = 0;
  bool done = !live;
  for (int base = 0; base < T; base += kTile) {
    const int n = min(kTile, T - base);
    __syncthreads();  // every thread is done with the previous tile
    for (int k = threadIdx.x; k < n * kTriCols; k += blockDim.x)
      s_tris[k] = tris[(size_t)base * kTriCols + k];
    __syncthreads();
    if (empty) continue;
    if (dense) {  // every record, counted once per tile
      if (done) continue;
      int stop = n;
      const float* tr = s_tris;
      for (int k = 0; k < n; ++k, tr += kTriCols) {
        if (test_record<kAny>(ro, rd, tr, cull != 0, base + k, best, bi)) {
          done = true;
          stop = k + 1;
          break;
        }
      }
      tests += stop;
      continue;
    }
    const Bundle b = make_bundle(live, ro, rd, live ? t_init[i] : 0.0f);
    for (int r = 0; r < n; r += 32) {
      if (__all_sync(kFull, done)) break;
      unsigned mask = round_mask(b, s_tris, r, n);
      while (mask) {
        const int k = r + __ffs(mask) - 1;
        mask &= mask - 1;
        if (done) continue;
        ++tests;
        done = test_record<kAny>(ro, rd, s_tris + kTriCols * k, cull != 0, base + k, best, bi);
      }
    }
  }
  if (live) {
    t_out[i] = best;
    idx_out[i] = bi;
    if (stats) stats[i] = tests;
  }
}

}  // namespace

// C entry point (bound with ctypes by ops/cuda/build.py): launches on the
// given stream, does not synchronise, returns the launch's cudaError_t.
extern "C" int mrt_panel(int R, int T, int cull, int any, const float* tris, const float* o,
                         const float* d, const float* t_init, float* t_out, int* idx_out,
                         int* stats, void* stream) {
  if (R <= 0) return 0;
  const int grid = (R + kBlock - 1) / kBlock;
  if (any)
    panel_kernel<true><<<grid, kBlock, 0, (cudaStream_t)stream>>>(R, T, cull, tris, o, d, t_init,
                                                                   t_out, idx_out, stats);
  else
    panel_kernel<false><<<grid, kBlock, 0, (cudaStream_t)stream>>>(R, T, cull, tris, o, d, t_init,
                                                                    t_out, idx_out, stats);
  return (int)cudaGetLastError();
}
