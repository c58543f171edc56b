// LBVH walk kernel for Hopper (sm_90a): the closest hit below t_init of
// every ray through the LBVH of ops/bvh.py (backend "bvh").
//
// Not a TPU kernel: the counterpart of the JAX package's LBVH walk, a
// vmapped lax.while_loop in jnp (mini_opencl_raytracer_tpu/ops/bvh.py:
// _intersect_one), which XLA compiles to one device program. Its plain
// version is ops/bvh.walk_plain, a host loop over the live rays that pops
// one node per ray per step; this kernel takes the loop onto the card, so
// that render(backend="bvh") captures into a CUDA graph (jit.py).
//
// Semantics (ops/bvh.walk_plain, in its order): one thread per ray, a
// stack of node ids in local memory, starting at the root. Pop the top
// node; slab-test its box against the ray's current best t (an inverted
// box, a subtree of padding slots, is a miss); at a leaf, Moller-Trumbore
// on its leaf_size slots in slot order (edges v1 - v0 and v2 - v0, then
// traverse.cuh's mt_hit_edges in ray_triangle_edges's order), a slot
// winning only where its t is strictly below the best so far, so that on
// equal t the first slot wins, as the plain walk's t.min(dim=1) does; at
// an inner node, push both children, the one with the nearer entry t on
// top (tn0 <= tn1 keeps child 0 on top). The slab test propagates NaN as
// torch.minimum / maximum / amax / amin and clamp do (fminf and fmaxf
// would drop it), so a NaN entry misses and orders as the plain walk's.
// Built with -fmad=false, so (t, slot) match the plain walk bit for bit.
//
// What bounds it: neither bytes nor operations but latency. Each ray is a
// chain of dependent loads (a node box, then its children's, then a
// leaf's slots) and divergent control flow: rays of a warp pop different
// nodes. This is the reference path, which `auto` never picks (large
// scenes go to the cluster kernel, csrc/clustered.cu): the design is the
// simple one that is right and capturable, no cull and no wide lanes.

#include "traverse.cuh"

namespace {

constexpr int kWalkBlock = 128;
// Stack entries a ray may hold: depth + 2 at most (ops/bvh.walk_plain's
// stack); the wrapper refuses deeper trees.
constexpr int kMaxStack = 64;

// torch.minimum / torch.maximum: NaN if either side is NaN.
__device__ __forceinline__ float tmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float tmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// ops/bvh._slab_test of the box (lo, hi) [3] against (o, inv_d) and the
// best t: returns the entry t before clamping and sets ``hit`` where
// min(tmax, t_best) >= max(tmin, 0) and the box is not inverted.
__device__ __forceinline__ float slab_box(const float* lo, const float* hi, V3 o, V3 inv,
                                          float t_best, bool& hit) {
  const V3 l = ld3(lo), h = ld3(hi);
  const float tx1 = (l.x - o.x) * inv.x, tx2 = (h.x - o.x) * inv.x;
  const float ty1 = (l.y - o.y) * inv.y, ty2 = (h.y - o.y) * inv.y;
  const float tz1 = (l.z - o.z) * inv.z, tz2 = (h.z - o.z) * inv.z;
  const float t0 = tmax(tmax(tmin(tx1, tx2), tmin(ty1, ty2)), tmin(tz1, tz2));
  const float t1 = tmin(tmin(tmax(tx1, tx2), tmax(ty1, ty2)), tmax(tz1, tz2));
  const float entry = isnan(t0) ? t0 : fmaxf(t0, 0.0f);
  hit = tmin(t1, t_best) >= entry && l.x <= h.x && l.y <= h.y && l.z <= h.z;
  return t0;
}

// ops/bvh.walk_plain's inverse direction: 1 / d, with |d| <= 1e-20 (and
// NaN) replaced by 1e-20.
__device__ __forceinline__ float inv_dir(float d) {
  return 1.0f / (fabsf(d) > 1e-20f ? d : 1e-20f);
}

__global__ void __launch_bounds__(kWalkBlock)
bvh_walk_kernel(int R, int leaves, int leaf_size, int cull, const float* __restrict__ node_lo,
                const float* __restrict__ node_hi, const float* __restrict__ pv0,
                const float* __restrict__ pv1, const float* __restrict__ pv2,
                const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ t_init, float* t_out, long long* slot_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const V3 ro = ld3(o + 3 * (size_t)i), rd = ld3(d + 3 * (size_t)i);
  const V3 inv = mk(inv_dir(rd.x), inv_dir(rd.y), inv_dir(rd.z));
  float best = t_init[i];
  long long slot = 0;
  int stack[kMaxStack];
  int sp = 1;
  stack[0] = 0;
  while (sp > 0) {
    const int node = stack[--sp];
    bool in_box;
    slab_box(node_lo + 3 * node, node_hi + 3 * node, ro, inv, best, in_box);
    if (!in_box) continue;
    if (node >= leaves - 1) {
      const int base = (node - (leaves - 1)) * leaf_size;
      for (int k = 0; k < leaf_size; ++k) {
        const size_t s = 3 * (size_t)(base + k);
        const V3 v0 = ld3(pv0 + s);
        float t;
        if (mt_hit_edges(ro, rd, v0, ld3(pv1 + s) - v0, ld3(pv2 + s) - v0, cull != 0, t) &&
            t < best) {
          best = t;
          slot = base + k;
        }
      }
    } else {
      const int c0 = 2 * node + 1, c1 = c0 + 1;
      bool unused;
      const float tn0 = slab_box(node_lo + 3 * c0, node_hi + 3 * c0, ro, inv, best, unused);
      const float tn1 = slab_box(node_lo + 3 * c1, node_hi + 3 * c1, ro, inv, best, unused);
      const bool near0 = tn0 <= tn1;
      stack[sp++] = near0 ? c1 : c0;
      stack[sp++] = near0 ? c0 : c1;
    }
  }
  t_out[i] = best;
  slot_out[i] = slot;
}

}  // namespace

// C entry point (bound with ctypes by ops/cuda/build.py): launches on the
// given stream, does not synchronise, returns the launch's cudaError_t.
extern "C" int mrt_bvh_walk(int R, int leaves, int leaf_size, int cull, const float* node_lo,
                            const float* node_hi, const float* pv0, const float* pv1,
                            const float* pv2, const float* o, const float* d,
                            const float* t_init, float* t_out, long long* slot_out,
                            void* stream) {
  if (R <= 0) return 0;
  const int grid = (R + kWalkBlock - 1) / kWalkBlock;
  bvh_walk_kernel<<<grid, kWalkBlock, 0, (cudaStream_t)stream>>>(
      R, leaves, leaf_size, cull, node_lo, node_hi, pv0, pv1, pv2, o, d, t_init, t_out,
      slot_out);
  return (int)cudaGetLastError();
}
