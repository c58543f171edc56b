// Cluster-traversal intersection kernel for Hopper (sm_90a): closest hit
// and any-hit of rays against a large scene laid out in clusters.
//
// Replaces mini_opencl_raytracer_tpu/ops/pallas/clustered.py:
// _clustered_kernel (K6), the intersector of the wavefront `pallas`
// backend above 2048 triangles. The TPU kernel walked one 2048-ray packet
// through the hierarchy with scalar control, DMA'd each hit cluster's
// limb-packed bf16 block into VMEM and ran Moller-Trumbore as MXU passes;
// here each ray is a thread walking the same hierarchy alone.
//
// Layout (ops/cuda/clustered.ClusteredGeometry): triangles sit in slots,
// CLUSTER = 128 slots per cluster, SUPER = 64 clusters per super; each
// slot holds an f32 (v0, e1, e2) record (zero on padding, so det == 0 and
// a padding slot never hits), its original triangle id and, optionally,
// its 34-float shading row. A cluster's real slots come first, and
// cl_count holds how many there are. Clusters and supers carry AABBs;
// empty boxes are far-away points that every slab test rejects.
//
// Per ray:
//   * supers are visited front to back by slab entry: each step picks the
//     smallest (entry, super index) after the last visited one among the
//     supers the ray's slab test still hits against its current best t;
//     the walk ends when none is left;
//   * inside a super, each of its 64 clusters is slab-tested against the
//     current best t (inclusive, so a box at exactly the best t is still
//     visited), and the real slots of every hit cluster run
//     Moller-Trumbore;
//   * the culling bound is best * (1 + kCullRel) + kCullAbs * scale / |d|,
//     scale = the largest |coordinate| of the scene's boxes and the ray's
//     origin. The slab entry is exact to a few ulps of itself, but M-T's t
//     is not: for a triangle whose corner or face lies on its cluster's
//     box, the hit can come out below the box's entry, by a few ulps of t
//     (the relative term) or, for a ray starting near the triangle, by
//     rounding of o - v0 at the scene's scale (the absolute term). Culling
//     such a box would let the order of the visits pick the winner; with
//     the slack the kernel finds the closest hit of every cluster the
//     ray's slab test hits at t_init. Near grazing incidence M-T's error
//     grows as 1 / cos and can outrun the slack: there a near-tie may
//     still go to the other candidate;
//   * a candidate wins if 0 < t < best, or t == best and its original
//     triangle id is lower (read through slot_to_tri only on equality):
//     the lowest id wins a tie, as in intersect_brute, whatever order the
//     clusters are visited in;
//   * closest mode writes t, the winner's slot (-1 on a miss) and,
//     optionally, its shading row (zeros on a miss); any mode stops at the
//     first hit below t_init.
// Semantics are ops/cuda/clustered.run_clustered_plain's, which tests every
// cluster the ray's slab test hits at t_init instead of culling by the
// running best t (that culling does not change the closest hit).
//
// What bounds it on this card: bytes, by the count below: a ray moves 28
// bytes in and 144 out (t, slot, the 136-byte row), and the scene is read
// once: a 36-byte record per real triangle (2.5 MB at bunny scale, 9.3 MB
// at sponza scale, resident in the 50 MB L2), the boxes, and the rows of
// the winners only. The operations (~45 flops per Moller-Trumbore test,
// about a hundred tests per ray) stay below it; what costs more than
// either is warp divergence: the 32 rays of a warp visit different
// supers and clusters, and a warp runs as long as its longest ray.
//
// What the design does about it: the super boxes (32 bytes each, 47 at
// sponza scale) are staged in shared memory; clusters and records are read
// from global memory as all lanes of a coherent warp read the same address
// (broadcast through L1); the integrator sorts the wavefront by direction
// octant and origin Morton code between bounces so that warps stay
// coherent. Reordering the visits, warp-level packets and compaction are
// left for later: the optional per-ray counts (stats: slots tested,
// clusters visited) measure what they would save.

#include "traverse.cuh"

namespace {

constexpr int kCluster = 128;
constexpr int kSuper = 64;
constexpr int kAabbCols = 8;
constexpr int kAttrCols = 34;
constexpr int kClusterBlock = 128;
constexpr float kCullRel = 1e-4f;
constexpr float kCullAbs = 64.0f * 1.1920929e-7f;   // 64 float32 ulps of 1

template <bool kAny>
__global__ void __launch_bounds__(kClusterBlock)
clustered_kernel(int R, int S, int cull, const float* __restrict__ sup_aabb,
                 const float* __restrict__ cl_aabb, const float* __restrict__ tris,
                 const int* __restrict__ slot_to_tri, const int* __restrict__ cl_count,
                 const float* __restrict__ attrs, const float* __restrict__ o,
                 const float* __restrict__ d, const float* __restrict__ t_init, float* t_out,
                 int* slot_out, float* rows_out, int* stats) {
  extern __shared__ float s_sup[];
  for (int k = threadIdx.x; k < S * kAabbCols; k += blockDim.x) s_sup[k] = sup_aabb[k];
  __syncthreads();
  // The scene's scale: the largest |coordinate| of the super boxes (far
  // points of empty boxes left out), reduced across the warp.
  float ext = 0.0f;
  for (int k = threadIdx.x % 32; k < S * 6; k += 32) {
    const float a = fabsf(s_sup[kAabbCols * (k / 6) + k % 6]);
    if (a < 1e37f) ext = fmaxf(ext, a);
  }
  for (int off = 16; off > 0; off >>= 1) ext = fmaxf(ext, __shfl_xor_sync(0xffffffffu, ext, off));
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;

  const V3 ro = ld3(o + 3 * (size_t)i), rd = ld3(d + 3 * (size_t)i);
  // 1 / d with |d| <= 1e-20 replaced by 1e-20 (the JAX kernel's slab).
  const V3 inv = mk(1.0f / (fabsf(rd.x) > 1e-20f ? rd.x : 1e-20f),
                    1.0f / (fabsf(rd.y) > 1e-20f ? rd.y : 1e-20f),
                    1.0f / (fabsf(rd.z) > 1e-20f ? rd.z : 1e-20f));
  const float scale = fmaxf(ext, fmaxf(fmaxf(fabsf(ro.x), fabsf(ro.y)), fabsf(ro.z)));
  const float reach = kCullAbs * scale / sqrtf(fmaxf(dot(rd, rd), 1e-30f));
  const bool cl = cull != 0;
  float best = t_init[i];
  int bs = -1;
  int tests = 0, visits = 0;

  float last_e = -1.0f;
  int last_s = -1;
  bool found = false;
  while (!found) {
    // The next super in (entry, index) order that the ray still hits.
    float ne = 0.0f;
    int ns = -1;
    for (int s = 0; s < S; ++s) {
      bool hit;
      const float e = slab(s_sup + kAabbCols * s, ro, inv, best + best * kCullRel + reach, hit);
      const bool after = e > last_e || (e == last_e && s > last_s);
      if (hit && after && (ns < 0 || e < ne)) {
        ne = e;
        ns = s;
      }
    }
    if (ns < 0) break;
    last_e = ne;
    last_s = ns;
    for (int c = 0; c < kSuper && !found; ++c) {
      const int j = ns * kSuper + c;
      bool hit;
      slab(cl_aabb + (size_t)kAabbCols * j, ro, inv, best + best * kCullRel + reach, hit);
      if (!hit) continue;
      ++visits;
      const int base = j * kCluster;
      const int n = min(cl_count[j], kCluster);
      for (int k = 0; k < n; ++k) {
        const int slot = base + k;
        float t;
        ++tests;
        if (!mt_hit(ro, rd, tris + (size_t)kTriCols * slot, cl, t)) continue;
        if (t < best) {
          best = t;
          bs = slot;
          if (kAny) {
            found = true;
            break;
          }
        } else if (t == best && bs >= 0 && slot_to_tri[slot] < slot_to_tri[bs]) {
          bs = slot;
        }
      }
    }
  }

  t_out[i] = best;
  slot_out[i] = bs;
  if (rows_out != nullptr) {
    float* row = rows_out + (size_t)kAttrCols * i;
    if (bs >= 0) {
      const float* src = attrs + (size_t)kAttrCols * bs;
      for (int k = 0; k < kAttrCols; ++k) row[k] = src[k];
    } else {
      for (int k = 0; k < kAttrCols; ++k) row[k] = 0.0f;
    }
  }
  if (stats != nullptr) {
    stats[2 * i] = tests;
    stats[2 * i + 1] = visits;
  }
}

}  // namespace

// C entry point (bound with ctypes by ops/cuda/build.py): launches on the
// given stream, does not synchronise, returns the launch's cudaError_t.
// ``attrs`` and ``rows_out`` are both null or both set; ``stats`` may be
// null.
extern "C" int mrt_clustered(int R, int S, int cull, int any, const float* sup_aabb,
                             const float* cl_aabb, const float* tris, const int* slot_to_tri,
                             const int* cl_count, const float* attrs, const float* o,
                             const float* d,
                             const float* t_init, float* t_out, int* slot_out, float* rows_out,
                             int* stats, void* stream) {
  if (R <= 0) return 0;
  const size_t smem = sizeof(float) * (size_t)S * kAabbCols;
  const int grid = (R + kClusterBlock - 1) / kClusterBlock;
  cudaError_t e;
  if (any) {
    e = allow_smem(clustered_kernel<true>, smem);
    if (e != cudaSuccess) return (int)e;
    clustered_kernel<true><<<grid, kClusterBlock, smem, (cudaStream_t)stream>>>(
        R, S, cull, sup_aabb, cl_aabb, tris, slot_to_tri, cl_count, attrs, o, d, t_init, t_out,
        slot_out, rows_out, stats);
  } else {
    e = allow_smem(clustered_kernel<false>, smem);
    if (e != cudaSuccess) return (int)e;
    clustered_kernel<false><<<grid, kClusterBlock, smem, (cudaStream_t)stream>>>(
        R, S, cull, sup_aabb, cl_aabb, tris, slot_to_tri, cl_count, attrs, o, d, t_init, t_out,
        slot_out, rows_out, stats);
  }
  return (int)cudaGetLastError();
}
