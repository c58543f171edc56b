// Cluster-traversal intersection kernel for Hopper (sm_90a): closest hit
// and any-hit of rays against a large scene laid out in clusters.
//
// Replaces mini_opencl_raytracer_tpu/ops/pallas/clustered.py:
// _clustered_kernel (K6), the intersector of the wavefront `pallas`
// backend above 2048 triangles. The TPU kernel walked one 2048-ray packet
// through a two-level super / cluster hierarchy with scalar control, DMA'd
// each hit cluster's limb-packed bf16 block into VMEM and ran
// Moller-Trumbore as MXU passes; here a group of kLanes lanes walks one
// ray through a tree over the clusters.
//
// Layout (ops/cuda/clustered.ClusteredGeometry): triangles sit in slots,
// CLUSTER = 128 slots per cluster; each slot holds an f32 (v0, e1, e2)
// record (zero on padding, so det == 0 and a padding slot never hits), its
// original triangle id and, optionally, its 34-float shading row. A
// cluster's real slots come first, and cl_count holds how many there are.
// Above the clusters, in slot order (a depth-first SAH leaf order or a
// Morton order, so neighbouring clusters lie close), sits an implicit
// kArity-ary tree: inner node n (heap order, root 0) has the children
// n * kArity + 1 ... n * kArity + kArity, and child n_inner + j is cluster
// j. No child index is stored. Boxes are 32-byte rows (lo.xyz, hi.xyz, two
// unused floats), read as a float4 and a float2. Empty boxes are far-away
// points (3e38 on every coordinate). The leaf level is padded up to a
// power of kArity, but only the C_pad real leaf rows exist: a child at or
// past n_inner + C_pad is never tested, so no walk leaves the arrays. The
// far point alone would not keep it out: a slab test with a t_far of 3e38
// or more passes it on a direction such as (1, 1, 1), where each axis
// gives the same finite entry.
//
// What bounds it on this card: neither bytes nor the counted operations.
// The function needs its rays (28 bytes in, 144 out with the row) and the
// scene once: a 36-byte record per real triangle (2.5 MB at bunny scale,
// 9.3 MB at sponza scale, resident in the 50 MB L2), the boxes, the rows
// of the winners; and ~45 flops per Moller-Trumbore test (~45 tests a
// config-3 primary ray, ~21 while the walk culled by the best t; the box
// tests are the walk's own cost, not the function's). That bound is 3-12%
// of the time (config 3 primary, sponza 4K). On a
// large launch (8.3 M rays at sponza scale) the kernel is set by its
// instruction stream: ~130 static instructions per M-T test in its loop
// under -fmad=false. On a small one (262 k rays at config 3) by its tail:
// a ray's walk is one serial chain of dependent loads and tests, the
// slowest ray of config 3 runs 1431 M-T tests, and with one lane per ray
// that ray alone took 1.97 M cycles of a 1.03 ms launch.
//
// What the design does about it:
//   * the tree replaces the flat scan. Before, each step of a ray's walk
//     slab-tested every super box to find the next one and then all 64
//     cluster boxes of that super: ~157 box tests per config-3 primary
//     ray for fewer than one cluster visit. Now a ray tests kArity
//     children per inner node it enters, ~31 boxes a ray;
//   * front to back: a node's hit children are sorted by (entry, index)
//     (a network of compare-exchanges in registers); the nearest is
//     entered at once and the others are pushed far to near on a short
//     per-thread stack (kStack entries, in local memory). No node is
//     culled by the best t found so far (see below), so a closest walk
//     visits the same clusters in any order; the order still pays: with a
//     ballot of the children hit, entered in index order, closest
//     launches ran 3-6% slower (and any launches 9% faster; PERF.md);
//   * kLanes = 4 lanes per ray: they slab-test a node's 4 children at once
//     and share the entries by shuffles, take a cluster's slots in rounds
//     of 4 (neighbouring lanes read neighbouring records), and reduce the
//     (t, id) key by shuffles; any mode stops at the first round with a
//     hit. A ray's chain is ~4x shorter, and a warp waits for the slowest
//     of 8 rays, not of 32. Every lane of a group keeps the same state and
//     stack, so the group's branches stay together;
//   * load balance: persistent warps take rays in batches of 8 from a
//     counter in device memory (Aila and Laine 2009), so a warp whose rays
//     finish early takes more, and no block waits for its slowest warp
//     while holding its slots. The last warp to finish zeroes the counter
//     for the next launch on the stream, so a launch needs no memset; the
//     wrapper works out the grid once per device.
//
// Why the tree changes no result. A parent's box is the min / max of its
// non-empty children's boxes (the same floats: it contains each of them
// bitwise). The slab test's per-axis distances fl(fl(x - o) * inv) are
// monotone in the box bound x, as each correctly rounded operation is, so
// a parent's interval [tmin, tmax] contains each child's, its entry
// max(tmin, 0) is no larger and its min(tmax, t_far) no smaller: a parent's
// slab test never rejects a box whose own test passes. So every cluster
// whose box the ray hits has all its ancestors hit, and the kernel reaches
// every cluster that the plain version tests, and, testing every box at
// t_init, no other. Why no cull by the best t: Moller-Trumbore's t can
// come out below the slab entry of its own cluster's box, by a few ulps of
// t on a face or corner of the box, by 1.2% of t for a ray starting near
// the triangle, and by a share of t that grows as 1 / cos of the ray to
// the triangle near grazing incidence (6% at cos 1e-4). A cull of the
// boxes whose entry lies beyond the best t plus a slack then drops a
// nearer hit (ops/cuda/parity.grazing_decoys). A sound slack needs, per
// node and ray, a lower bound on |cos| over the node's triangles; on the
// bunny and sponza scenes, in 90% of the clusters some normal lies 82
// degrees or more from the axis of their normals' cone, so a cone's bound
// is 0 at 93-97% of the nodes tested, and a cull with it saved 0.4% of
// the M-T tests (PERF.md). A candidate wins if 0 < t < best, or t == best
// and its original triangle id is lower (read through slot_to_tri only on
// equality), so the result is the least (t, id) key over the clusters
// reached, whatever the order of the visits, the split of a cluster's
// slots over lanes, the stack discipline or the split of rays over warps.
//
// Semantics are ops/cuda/clustered.run_clustered_plain's, which tests every
// cluster the ray's slab test hits at t_init, in one flat pass instead of
// walking the tree; ops/cuda/clustered_walk.py models the
// walk itself, stack order and counts included. Closest mode writes t, the
// winner's slot (-1 on a miss) and, optionally, its shading row (zeros on
// a miss); any mode stops at the end of the first round of slots that
// holds a hit below t_init. The optional
// per-ray counts (stats: M-T tests, cluster visits, box tests) measure the
// walk; built with -DMRT_K6_CYCLES (scripts/k6_cycles.py), the third
// column holds the clock64 cycles of the ray's walk instead.

#include "traverse.cuh"

namespace {

constexpr int kCluster = 128;
constexpr int kArity = 4;
constexpr int kLanes = 4;   // lanes per ray, a power of 2 up to 32
constexpr int kStack = 64;
constexpr int kAabbCols = 8;
constexpr int kAttrCols = 34;
constexpr int kClusterBlock = 128;

struct Scene {
  int R, n_inner, n_clusters, cull;   // n_clusters = C_pad
  const float* tree;         // [n_inner, 8] inner nodes
  const float* cl_aabb;      // [C_pad, 8] clusters: the leaves
  const float* tris;         // [T_pad, 9]
  const int* slot_to_tri;    // [T_pad]
  const int* cl_count;       // [C_pad]
  const float* attrs;        // [T_pad, 34] or null
  const float* o;
  const float* d;
  const float* t_init;
  float* t_out;
  int* slot_out;
  float* rows_out;           // [R, 34] or null
  int* stats;                // [R, 3] or null
};

// A group of kLanes lanes of one warp walks one ray; ``g`` is the lane's
// index in its group and ``gmask`` the group's lanes.
template <typename T>
__device__ __forceinline__ T gshfl(unsigned gmask, T v, int src) {
  return __shfl_sync(gmask, v, src, kLanes);
}

// The walk of ray i by its group. Every lane of the group holds the same
// ray state, stack and node; the lanes split the children's slab tests and
// a cluster's slots.
template <bool kAny>
__device__ __forceinline__ void trace(const Scene& s, int i, int g, unsigned gmask) {
  const float kMiss = __int_as_float(0x7f800000);   // +inf: a child the ray misses
  const V3 ro = ld3(s.o + 3 * (size_t)i), rd = ld3(s.d + 3 * (size_t)i);
  // 1 / d with |d| <= 1e-20 replaced by 1e-20 (the JAX kernel's slab).
  const V3 inv = mk(1.0f / (fabsf(rd.x) > 1e-20f ? rd.x : 1e-20f),
                    1.0f / (fabsf(rd.y) > 1e-20f ? rd.y : 1e-20f),
                    1.0f / (fabsf(rd.z) > 1e-20f ? rd.z : 1e-20f));
  const bool cl = s.cull != 0;
#ifdef MRT_K6_CYCLES
  const long long clk0 = clock64();
#endif
  const float lim = s.t_init[i];
  float best = lim;
  int bs = -1;
  int tests = 0, visits = 0, boxes = 1;
  int stack[kStack];
  int sp = 0;

  bool hit;
  slab(s.tree, ro, inv, lim, hit);
  int node = hit ? 0 : -1;
  while (node >= 0) {
    // Descend through inner nodes until this ray holds a cluster (or has
    // nothing left), so the warp's groups run the M-T loop together.
    while (node >= 0 && node < s.n_inner) {
      const int c0 = node * kArity + 1;
      const float* rows = c0 < s.n_inner ? s.tree + (size_t)kAabbCols * c0
                                         : s.cl_aabb + (size_t)kAabbCols * (c0 - s.n_inner);
      // The children that exist: all kArity of an inner level, the real
      // leaf rows (none past C_pad) of the last.
      const int kids = max(min(kArity, s.n_inner + s.n_clusters - c0), 0);
      // Lane g tests children g, g + kLanes, ...; the group then shares
      // the keys, so every lane sorts the same (entry, index) pairs.
      constexpr int kPer = (kArity + kLanes - 1) / kLanes;
      float mine[kPer];
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int k = g + q * kLanes;
        mine[q] = kMiss;
        if (k < kids) {
          bool h;
          const float e = slab(rows + kAabbCols * k, ro, inv, lim, h);
          if (h) mine[q] = e;
        }
      }
      float key[kArity];
      int id[kArity];
#pragma unroll
      for (int k = 0; k < kArity; ++k) {
        key[k] = gshfl(gmask, mine[k / kLanes], k % kLanes);
        id[k] = c0 + k;
      }
      boxes += kids;
      // Sort by (entry, index): adjacent compare-exchanges on strict >,
      // which keep equal entries in index order.
#pragma unroll
      for (int m = 1; m < kArity; ++m) {
#pragma unroll
        for (int k = m; k > 0; --k) {
          if (key[k - 1] > key[k]) {
            const float tk = key[k - 1];
            key[k - 1] = key[k];
            key[k] = tk;
            const int ti = id[k - 1];
            id[k - 1] = id[k];
            id[k] = ti;
          }
        }
      }
#pragma unroll
      for (int k = kArity - 1; k > 0; --k) {
        if (key[k] != kMiss) stack[sp++] = id[k];
      }
      node = key[0] != kMiss ? id[0] : sp > 0 ? stack[--sp] : -1;
    }
    while (node >= s.n_inner) {
      // The cluster's real slots, lane g taking g, g + kLanes, ... in
      // rounds of kLanes slots.
      const int j = node - s.n_inner;
      ++visits;
      const int base = j * kCluster;
      const int n = min(s.cl_count[j], kCluster);
      float lt = best;
      int ls = bs, tested = n;
      for (int r0 = 0; r0 < n; r0 += kLanes) {
        const int slot = base + r0 + g;
        float t = 0.0f;
        const bool h = r0 + g < n && mt_hit(ro, rd, s.tris + (size_t)kTriCols * slot, cl, t);
        if (kAny) {
          // The round's lowest slot below the limit ends the walk.
          const unsigned won = __ballot_sync(gmask, h && t < best) & gmask;
          if (won) {
            const int src = __ffs(won) - 1 - (threadIdx.x % 32 - g);
            best = gshfl(gmask, t, src);
            bs = base + r0 + src;
            tested = min(n, r0 + kLanes);
            sp = 0;
            break;
          }
        } else if (h) {
          if (t < lt) {
            lt = t;
            ls = slot;
          } else if (t == lt && ls >= 0 && s.slot_to_tri[slot] < s.slot_to_tri[ls]) {
            ls = slot;
          }
        }
      }
      tests += tested;
      if (!kAny) {
        // The group's least (t, id): every lane ends with the same pair.
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1) {
          const float ot = __shfl_xor_sync(gmask, lt, off, kLanes);
          const int os = __shfl_xor_sync(gmask, ls, off, kLanes);
          if (ot < lt || (ot == lt && os != ls && os >= 0 &&
                          (ls < 0 || s.slot_to_tri[os] < s.slot_to_tri[ls]))) {
            lt = ot;
            ls = os;
          }
        }
        best = lt;
        bs = ls;
      }
      node = sp > 0 ? stack[--sp] : -1;
    }
  }

  if (g == 0) {
    s.t_out[i] = best;
    s.slot_out[i] = bs;
    if (s.stats != nullptr) {
      s.stats[3 * i] = tests;
      s.stats[3 * i + 1] = visits;
#ifdef MRT_K6_CYCLES
      s.stats[3 * i + 2] = (int)(clock64() - clk0);
#else
      s.stats[3 * i + 2] = boxes;
#endif
    }
  }
  if (s.rows_out != nullptr) {
    float* row = s.rows_out + (size_t)kAttrCols * i;
    const float* src = s.attrs + (size_t)kAttrCols * bs;
    for (int k = g; k < kAttrCols; k += kLanes) row[k] = bs >= 0 ? src[k] : 0.0f;
  }
}

// ``counter`` holds the next ray and the warps done; both are 0 at the
// launch, and the last warp to finish sets them to 0 again.
template <bool kAny>
__global__ void __launch_bounds__(kClusterBlock)
clustered_kernel(Scene s, int* counter) {
  const int lane = threadIdx.x % 32, g = lane % kLanes;
  const unsigned gmask = (kLanes == 32 ? 0xffffffffu : (1u << kLanes) - 1u) << (lane - g);
  for (;;) {
    int first = 0;
    if (lane == 0) first = atomicAdd(counter, 32 / kLanes);
    first = __shfl_sync(0xffffffffu, first, 0);
    if (first >= s.R) break;
    const int i = first + lane / kLanes;
    if (i < s.R) trace<kAny>(s, i, g, gmask);
  }
  // A warp counts itself done only after its last take from the counter
  // returned, so the last one to count sees every take made.
  const int warps = gridDim.x * (kClusterBlock / 32);
  if (lane == 0 && atomicAdd(counter + 1, 1) == warps - 1) {
    atomicExch(counter, 0);
    atomicExch(counter + 1, 0);
  }
}

}  // namespace

// C entry points (bound with ctypes by ops/cuda/build.py).
//
// mrt_clustered_blocks_per_sm: how many blocks of the closest (any == 0)
// or any-hit kernel an SM holds at once, into *out; returns the
// cudaError_t.
extern "C" int mrt_clustered_blocks_per_sm(int any, int* out) {
  return (int)(any ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, clustered_kernel<true>,
                                                                   kClusterBlock, 0)
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, clustered_kernel<false>,
                                                                   kClusterBlock, 0));
}

// mrt_clustered: launches ``grid`` blocks of persistent warps on the given
// stream, does not synchronise, returns the launch's cudaError_t.
// ``n_clusters`` is C_pad, the rows of cl_aabb and cl_count. ``attrs`` and
// ``rows_out`` are both null or both set; ``stats`` may be null;
// ``counter`` is two ints of device memory, zero before the first launch,
// used by one stream at a time.
extern "C" int mrt_clustered(int R, int n_inner, int n_clusters, int grid, int cull, int any,
                             const float* tree, const float* cl_aabb, const float* tris,
                             const int* slot_to_tri, const int* cl_count, const float* attrs,
                             const float* o, const float* d, const float* t_init, float* t_out,
                             int* slot_out, float* rows_out, int* stats, int* counter,
                             void* stream) {
  if (R <= 0) return 0;
  const Scene s{R, n_inner, n_clusters, cull, tree, cl_aabb, tris, slot_to_tri, cl_count,
                attrs, o, d, t_init, t_out, slot_out, rows_out, stats};
  const cudaStream_t st = (cudaStream_t)stream;
  if (any)
    clustered_kernel<true><<<grid, kClusterBlock, 0, st>>>(s, counter);
  else
    clustered_kernel<false><<<grid, kClusterBlock, 0, st>>>(s, counter);
  return (int)cudaGetLastError();
}
