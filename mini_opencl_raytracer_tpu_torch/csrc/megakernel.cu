// Fused path-tracing bounce kernels for Hopper (sm_90a).
//
// Two entry points share one __device__ bounce body:
//
//   bounce0_fwd_kernel  replaces mini_opencl_raytracer_tpu/ops/pallas/
//                       megakernel.py:_bounce0_fwd_kernel (K1): jittered
//                       pinhole raygen and per-pixel seeds in-kernel, then
//                       the first bounce.
//   bounce_fwd_kernel   replaces megakernel.py:_bounce_fwd_kernel (K2): one
//                       bounce from the carried ray state (bounces >= 1);
//                       with F_RESID (cfg.bwd_residuals, the JAX kernel's
//                       save_resid) it also stores the known-value
//                       residual rows that the backward K4 reads, each
//                       where the bounce computes its value, at the ray's
//                       rank among the rays alive with a winner.
//
// A bounce is: closest hit over all triangles (Moller-Trumbore, exact f32
// divide, strict '<' so the lowest index wins a tie, |det| > 1e-10 or
// det > 1e-10 under backface culling, t < t_max); the winner's shading row;
// sky / emission / soft-edge coverage; Blinn or GGX lobe sampling with the
// counter-based lowbias32 RNG; direct light over all lights with optional
// any-hit shadow rays; throughput update and the next ray. The arithmetic
// follows the plain PyTorch version (ops/integrator.shade_hit and its
// callees) operation for operation; seeds and uniforms are bit-identical.
// Everything after the closest hit (``shade``, with its any-hit shadow
// rays) lives in shade.cuh, which the wavefront's fused shading (shade.cu)
// shares.
//
// What bounds it on this card. For Cornell (36 triangles) a live ray moves
// ~104 bytes of state but runs 36 (plus 36 per light with shadow rays)
// Moller-Trumbore tests and a few dozen transcendentals, and rays of one
// warp take different lobes, miss, or die at different bounces. A dead ray
// only passes its state through (100 bytes). On the main path (1080p x 9,
// H100, scripts/ab_mega.py) K2 takes 0.075 ms with every ray dead: that
// stream alone, 207 MB at ~2.8 TB/s, is 60-70% of every bounce >= 1, and
// the live rays' bodies add to it rather than hide under it (0.210 ms with
// every ray alive).
//
// What the design does about it:
//   * K1: one thread per ray, a 1-D grid, the ragged tail masked; its
//     closest hit and shadow rays run behind the per-warp cull of
//     bundle.cuh;
//   * K2: a block per tile of 128 rays, or of 512 where a live ray runs
//     more than 256 Moller-Trumbore tests; where a tile's live rays hold
//     more warps than ceil(live / 32), they are packed in ray order into
//     that many warps, so a warp runs the bounce on up to 32 live rays
//     instead of the few a warp of consecutive rays holds at the later
//     bounces (PERF.md: 0.24 of its lanes at bounce 8). One block per
//     tile lets the card refill a slot as soon as a tile is done. Designs
//     that pack across the whole launch (a persistent grid with a queue
//     per block or per warp, a queue kernel and a bounce kernel) ran
//     1.25-1.4x slower over bounces 1-8 in design runs whose sources were
//     not kept (PERF.md): that comparison cannot be rerun from this file;
//   * the triangles (v0, e1, e2: 36 bytes each) and the lights are staged
//     in shared memory once per block, so the intersection loops read
//     broadcast shared memory, never device memory;
//   * the winner's attributes come from one 128-byte row of a
//     triangle-major [T_pad, 32] table (replacing the TPU's one-hot
//     matmul gather);
//   * rays that are dead skip the bounce, only the picked lobe is
//     evaluated, and shadow rays exit at the first occluder;
//   * the RNG counters are premixed on the host and passed as scalars.
// Tensor cores, TMA and ray sorting are left for later.
//
// Built without fast-math and with -fmad=false (ops/cuda/build.py), and
// every expression is written in the plain version's operation order, so
// the kernels round as the plain version does on the card. That matters
// for ties: where two triangles overlap in one plane (the Cornell boxes'
// bottoms lie on the floor, visible through culled box walls under
// backface culling) the winner is decided by the last ulp of t. With FMA
// contraction, culling flipped 13 of 4096 winners (0.3%) at 64x64 and 271
// of 262,144 (0.1%) at 512x512 against the plain version; without it,
// none.

#include "bundle.cuh"
#include "megakernel.cuh"
#include "raygen.cuh"
#include "shade.cuh"

namespace {

// One closest-hit test of record ``tr``: true where its t is below t_best,
// with (t, u, v) and 1 / det. NaN-safe comparisons reject what the plain
// version's (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0) rejects.
__device__ __forceinline__ bool mt_closest(const float* tr, V3 o, V3 d, bool cull,
                                           float t_best, float& t_out, float& u_out,
                                           float& v_out, float& inv_out) {
  const V3 v0 = ld3(tr), e1 = ld3(tr + 3), e2 = ld3(tr + 6);
  const V3 pvec = cross(d, e2);
  const float det = dot(e1, pvec);
  if (!(cull ? det > kDetEps : fabsf(det) > kDetEps)) return false;
  const float inv = 1.0f / det;
  const V3 tvec = o - v0;
  const float u = dot(tvec, pvec) * inv;
  if (!(u >= 0.0f)) return false;
  const V3 qvec = cross(tvec, e1);
  const float v = dot(d, qvec) * inv;
  if (!(v >= 0.0f) || !(u + v <= 1.0f)) return false;
  const float t = dot(e2, qvec) * inv;
  if (!(t > 0.0f && t < t_best)) return false;
  t_out = t;
  u_out = u;
  v_out = v;
  inv_out = inv;
  return true;
}

// Closest hit over the staged triangles. Returns the winner index (-1 on a
// miss) and its (t, u, v) and 1 / det; a strict '<' in index order, so the
// lowest index wins a tie.
__device__ __forceinline__ int closest_hit(const float* s_tris, int T, V3 o, V3 d,
                                           float t_max, bool cull, float& t_out,
                                           float& u_out, float& v_out, float& inv_out) {
  int best = -1;
  float t_best = t_max;
  for (int k = 0; k < T; ++k)
    if (mt_closest(s_tris + kTriCols * k, o, d, cull, t_best, t_best, u_out, v_out, inv_out))
      best = k;
  t_out = t_best;
  return best;
}

// closest_hit behind the warp's cull (bundle.cuh): called by all 32 lanes;
// a lane with ``live`` false tests nothing and misses. ``tests`` counts
// this lane's exact tests.
__device__ __forceinline__ int closest_bundle(const float* s_tris, int T, V3 o, V3 d,
                                              float t_max, bool cull, bool live, float& t_out,
                                              float& u_out, float& v_out, int& tests) {
  const Bundle b = make_bundle(live, o, d, t_max);
  float inv;  // K1 keeps no rows
  if (b.dense) {  // the whole warp runs closest_hit's loop
    t_out = t_max;
    if (!live) return -1;
    tests += T;
    return closest_hit(s_tris, T, o, d, t_max, cull, t_out, u_out, v_out, inv);
  }
  int best = -1;
  float t_best = t_max;
  for (int r = 0; r < T; r += 32) {
    unsigned mask = round_mask(b, s_tris, r, T);
    while (mask) {
      const int k = r + __ffs(mask) - 1;
      mask &= mask - 1;
      if (!live) continue;
      ++tests;
      if (mt_closest(s_tris + kTriCols * k, o, d, cull, t_best, t_best, u_out, v_out, inv))
        best = k;
    }
  }
  t_out = t_best;
  return best;
}

// One bounce of a ray: the closest hit, then shade. Without kCull a ray
// that is not alive passes through.
template <bool kCull>
__device__ RayOut bounce_body(const MegaParams& p, const float* s_tris, const float* s_lights,
                              const float* __restrict__ tab, V3 o, V3 d, V3 beta, bool alive,
                              uint32_t seed, int& tests) {
  if (!kCull && !alive) return pass_through(o, d, beta);
  const bool cull = p.flags & F_CULL;
  float t, u = 0.0f, v = 0.0f, inv = 0.0f;
  const int best =
      kCull ? closest_bundle(s_tris, p.num_tris, o, d, p.t_max, cull, alive, t, u, v, tests)
            : closest_hit(s_tris, p.num_tris, o, d, p.t_max, cull, t, u, v, inv);
  return shade<kCull, false>(p, s_tris, s_lights, tab, o, d, beta, alive, seed, tests, best, t,
                             u, v, inv, nullptr, 0);
}

// Stage triangles and lights in shared memory (every thread of the block
// reaches the barrier).
__device__ __forceinline__ void stage(const MegaParams& p, const float* __restrict__ tris,
                                      const float* __restrict__ lights, float* s_tris,
                                      float* s_lights) {
  const int nt = p.num_tris * kTriCols, nl = p.num_lights * kLightCols;
  for (int k = threadIdx.x; k < nt; k += blockDim.x) s_tris[k] = tris[k];
  for (int k = threadIdx.x; k < nl; k += blockDim.x) s_lights[k] = lights[k];
  __syncthreads();
}

__device__ __forceinline__ void store(const RayOut& r, int i, int R, float* o, float* d,
                                      float* beta, float* alive, float* rad, int* idx,
                                      int* occ) {
  const V3* vecs[4] = {&r.o, &r.d, &r.beta, &r.rad};
  float* outs[4] = {o, d, beta, rad};
  for (int j = 0; j < 4; ++j) {
    outs[j][i] = vecs[j]->x;
    outs[j][R + i] = vecs[j]->y;
    outs[j][2 * R + i] = vecs[j]->z;
  }
  alive[i] = r.alive ? 1.0f : 0.0f;
  idx[i] = r.winner;
  occ[i] = r.occ;
}

__global__ void __launch_bounds__(kBlock)
bounce0_fwd_kernel(MegaParams p, const uint32_t* __restrict__ frame_cm,
                   const float* __restrict__ tab, const float* __restrict__ tris,
                   const float* __restrict__ lights, const float* __restrict__ cam,
                   const int* __restrict__ pixel_ids, float* o_out, float* d_out,
                   float* beta_out, float* alive_out, float* rad_out, int* idx_out,
                   int* occ_out, int* seeds_out, int* stats) {
  extern __shared__ float smem[];
  float* s_tris = smem;
  float* s_lights = smem + p.num_tris * kTriCols;
  stage(p, tris, lights, s_tris, s_lights);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // Lanes past the last ray stay for the warp's cull, without a ray.
  const bool in = i < p.num_rays;

  // Raygen (raygen.cuh); the frame's premix comes from device memory.
  const Raygen g = raygen(p, cam, in ? pixel_ids[i] : 0, *frame_cm);

  int tests = 0;
  const RayOut r = bounce_body<true>(p, s_tris, s_lights, tab, g.o, g.d, mk(1.0f, 1.0f, 1.0f),
                                     in, g.seed, tests);
  if (!in) return;
  store(r, i, p.num_rays, o_out, d_out, beta_out, alive_out, rad_out, idx_out, occ_out);
  seeds_out[i] = (int)g.seed;
  if (stats) stats[i] = tests;
}

// K2 with rows: each ray's rank among the bounce's rays that are alive and
// have a winner, and its rows in that rank's column. Thread t of a block
// holds the tile's t-th ray (packed or not), so a ray's rank within its
// tile is the count of such rays before it (a ballot per warp, the warps'
// counts in shared memory). The tile's offset is one atomicAdd of its
// count to ``count`` (zeroed before the launch, the total after it): the
// tile's rays take the next columns in ray order, so a warp's stores are
// consecutive and the ranks are 0 .. count - 1. Tiles take their columns
// in the order they finish their closest hits, so which tile holds which
// columns can differ between runs; a ray's rows, read through its rank,
// are the same bits. An offset in ray order over the whole grid cost
// 0.06-0.11 ms more a launch at 1080p bounce 1 (PERF.md): a
// decoupled look-back waits on tiles of its own wave, which run their
// phases together, and a separate scan and copy of the rows are bound by
// their latency.

// A block takes its tile: each thread reads its ray's alive flag and
// state, a ballot per warp counts the live rays, and the barrier that
// stages the triangles and lights also publishes the counts. A ray that
// is not alive writes its pass-through. Where
// packing the live rays would run the bounce on fewer warps than hold
// them, the block queues them in ray order in shared memory and its first
// ceil(live / 32) warps run the bounce on the queue, full but the last;
// elsewhere each live ray runs in its own lane. A ray's state is read at
// its index and its results stored there, so its arithmetic, and its
// bits, are the same in whichever lane runs it. A block has kTile threads
// for a tile of kTile rays (mrt_bounce_fwd picks 128 or 512), at most 64
// registers a thread.
//
// kResid: after the closest hit every thread of the block takes part in
// the ranking above (a dead ray's rank is -1), and shade stores the ray's
// rows in its rank's column of ``resid`` ([n, R], rows_of).
template <int kTile, bool kResid>
__global__ void __launch_bounds__(kTile, 1024 / kTile)
bounce_fwd_kernel(MegaParams p, const float* __restrict__ tab, const float* __restrict__ tris,
                  const float* __restrict__ lights, const float* __restrict__ o_in,
                  const float* __restrict__ d_in, const float* __restrict__ beta_in,
                  const float* __restrict__ alive_in, const int* __restrict__ seeds,
                  float* o_out, float* d_out, float* beta_out, float* alive_out,
                  float* rad_out, int* idx_out, int* occ_out, float* resid, int* rank,
                  int* count) {
  extern __shared__ float smem[];
  __shared__ int s_queue[kTile];
  __shared__ int s_cnt[kTile / 32];
  float* s_tris = smem;
  float* s_lights = smem + p.num_tris * kTriCols;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, R = p.num_rays;
  const int i = blockIdx.x * kTile + tid;
  const bool in = i < R;
  // Every ray's flag and state at once: a ray that stays in its lane needs
  // no second trip to memory, and one that is packed finds its lines in L2.
  const int k = in ? i : 0;
  const bool live = in && alive_in[k] > 0.0f;
  V3 o = mk(o_in[k], o_in[R + k], o_in[2 * R + k]);
  V3 d = mk(d_in[k], d_in[R + k], d_in[2 * R + k]);
  V3 beta = mk(beta_in[k], beta_in[R + k], beta_in[2 * R + k]);
  const unsigned took = __ballot_sync(kFull, live);
  if (lane == 0) s_cnt[warp] = __popc(took);
  stage(p, tris, lights, s_tris, s_lights);  // its barrier also publishes s_cnt
  int at = 0, n = 0, holding = 0;  // warps with a live ray
  for (int w = 0; w < kTile / 32; ++w) {
    const int c = s_cnt[w];
    at = w == warp ? n : at;
    n += c;
    holding += c > 0;
  }
  if (in && !live) {
    store(pass_through(o, d, beta), i, R, o_out, d_out, beta_out, alive_out, rad_out, idx_out,
          occ_out);
    if constexpr (kResid) rank[i] = -1;
  }
  int j = live ? i : -1;
  if ((n + 31) / 32 < holding) {  // pack: the same in every thread
    if (live) s_queue[at + __popc(took & ((1u << lane) - 1u))] = i;
    __syncthreads();
    j = tid < n ? s_queue[tid] : -1;
    if (j >= 0 && j != i) {
      o = mk(o_in[j], o_in[R + j], o_in[2 * R + j]);
      d = mk(d_in[j], d_in[R + j], d_in[2 * R + j]);
      beta = mk(beta_in[j], beta_in[R + j], beta_in[2 * R + j]);
    }
  }
  int tests = 0;
  if constexpr (kResid) {
    __shared__ int s_hits[kTile / 32], s_off;
    float t = p.t_max, u = 0.0f, v = 0.0f, inv = 0.0f;
    const int best = j >= 0 ? closest_hit(s_tris, p.num_tris, o, d, p.t_max, p.flags & F_CULL,
                                          t, u, v, inv)
                            : -1;
    const bool hit = best >= 0;
    const unsigned won = __ballot_sync(kFull, hit);
    if (lane == 0) s_hits[warp] = __popc(won);
    __syncthreads();
    int local = __popc(won & ((1u << lane) - 1u)), total = 0;
    for (int w = 0; w < kTile / 32; ++w) {
      const int c = s_hits[w];
      local += w < warp ? c : 0;
      total += c;
    }
    if (tid == 0) s_off = atomicAdd(count, total);
    __syncthreads();
    if (j < 0) return;
    rank[j] = hit ? s_off + local : -1;
    float* rs = hit ? resid + s_off + local : nullptr;
    const RayOut r = shade<false, true>(p, s_tris, s_lights, tab, o, d, beta, true,
                                        (uint32_t)seeds[j], tests, best, t, u, v, inv, rs, R);
    store(r, j, R, o_out, d_out, beta_out, alive_out, rad_out, idx_out, occ_out);
  } else {
    if (j < 0) return;
    const RayOut r = bounce_body<false>(p, s_tris, s_lights, tab, o, d, beta, true,
                                        (uint32_t)seeds[j], tests);
    store(r, j, R, o_out, d_out, beta_out, alive_out, rad_out, idx_out, occ_out);
  }
}

// The mega path's scene limit (ops/cuda/megakernel.py _MAX_TRIS,
// MAX_LIGHTS): the most a block stages.
constexpr int kMaxTris = 2048, kMaxLights = 30;

size_t smem_bytes(const MegaParams& p) {
  return sizeof(float) * ((size_t)p.num_tris * kTriCols + (size_t)p.num_lights * kLightCols);
}

// Above 48 KB of dynamic shared memory a kernel must opt in. Once per
// kernel, at its first such launch, for the most any launch stages, so
// that later launches (a captured one among them) make no such call.
template <auto kKernel>
cudaError_t prepare(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  static const cudaError_t e = cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float) * (kMaxTris * kTriCols + kMaxLights * kLightCols)));
  return e;
}

int check_scene(const MegaParams& p) {
  return p.num_tris > kMaxTris || p.num_lights > kMaxLights || (p.flags & ~kKnownFlags)
             ? (int)cudaErrorInvalidValue
             : 0;
}

// kResid: ``count`` (the kernel's last argument) is zeroed on the stream
// first.
template <int kTile, bool kResid, typename... Args>
int launch_bounce_fwd(const MegaParams& p, cudaStream_t stream, int* count, Args... args) {
  const size_t smem = smem_bytes(p);
  cudaError_t e = prepare<bounce_fwd_kernel<kTile, kResid>>(smem);
  if (e != cudaSuccess) return (int)e;
  if (kResid && (e = cudaMemsetAsync(count, 0, sizeof(int), stream)) != cudaSuccess)
    return (int)e;
  const int grid = (p.num_rays + kTile - 1) / kTile;
  bounce_fwd_kernel<kTile, kResid><<<grid, kTile, smem, stream>>>(p, args..., count);
  return (int)cudaGetLastError();
}

template <int kTile, typename... Args>
int launch_tile(const MegaParams& p, cudaStream_t stream, int* count, Args... args) {
  return (p.flags & F_RESID) ? launch_bounce_fwd<kTile, true>(p, stream, count, args...)
                             : launch_bounce_fwd<kTile, false>(p, stream, count, args...);
}

}  // namespace

// C entry points (bound with ctypes by ops/cuda/build.py). Each launches
// on the given stream, does not synchronise, and returns the launch's
// cudaError_t.
// mrt_bounce0_fwd's frame_cm points at one u32 on the device: premix of
// the frame (ops/rng.premix).
extern "C" int mrt_bounce0_fwd(const MegaParams* p, const uint32_t* frame_cm, const float* tab,
                               const float* tris, const float* lights, const float* cam,
                               const int* pixel_ids, float* o, float* d, float* beta,
                               float* alive, float* rad, int* idx, int* occ, int* seeds,
                               int* stats, void* stream) {
  if (p->num_rays <= 0) return 0;
  if (check_scene(*p)) return check_scene(*p);
  if (p->flags & F_RESID) return (int)cudaErrorInvalidValue;  // K1 has no residual mode
  const size_t smem = smem_bytes(*p);
  cudaError_t e = prepare<bounce0_fwd_kernel>(smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (p->num_rays + kBlock - 1) / kBlock;
  bounce0_fwd_kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      *p, frame_cm, tab, tris, lights, cam, pixel_ids, o, d, beta, alive, rad, idx, occ, seeds,
      stats);
  return (int)cudaGetLastError();
}

// mrt_bounce_fwd with F_RESID: resid the [n, R] rows (rows_of) by rank,
// rank [R] each ray's rank among the rays alive with a winner (-1 for the
// others), count [1] their number; all null without it.
extern "C" int mrt_bounce_fwd(const MegaParams* p, const float* tab, const float* tris,
                              const float* lights, const float* o_in, const float* d_in,
                              const float* beta_in, const float* alive_in, const int* seeds,
                              float* o, float* d, float* beta, float* alive, float* rad,
                              int* idx, int* occ, float* resid, int* rank, int* count,
                              void* stream) {
  if (p->num_rays <= 0) return 0;
  if (check_scene(*p)) return check_scene(*p);
  if ((p->flags & F_RESID) && !(resid && rank && count)) return (int)cudaErrorInvalidValue;
  // K2's tile: 128 rays while a live ray runs at most 256 Moller-Trumbore
  // tests (the triangles, and as many again per light with shadow rays),
  // else 512. A larger tile packs its live rays into fuller warps: on
  // bounces 1-8 at 1080p it was 5-6% slower at 36 and 256 tests, even at
  // 108, and 2-10% faster from 324 tests on (PERF.md, section 6). With
  // ~2048 triangles staged (75.6 KB) an SM holds two blocks, and tiles of
  // 128 would leave it 256 threads (2.25x slower there).
  const long tests = (long)p->num_tris * (1 + ((p->flags & F_SHADOW) ? p->num_lights : 0));
  const cudaStream_t s = (cudaStream_t)stream;
  if (tests > 256)
    return launch_tile<512>(*p, s, count, tab, tris, lights, o_in, d_in, beta_in, alive_in, seeds,
                            o, d, beta, alive, rad, idx, occ, resid, rank);
  return launch_tile<128>(*p, s, count, tab, tris, lights, o_in, d_in, beta_in, alive_in, seeds,
                          o, d, beta, alive, rad, idx, occ, resid, rank);
}

extern "C" const char* mrt_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }
