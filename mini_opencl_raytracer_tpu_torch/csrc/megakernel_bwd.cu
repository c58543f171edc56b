// Backward bounce kernels for Hopper (sm_90a): the vector-Jacobian product
// of one fused bounce with the winner triangle and the occlusion bits that
// the forward kernel recorded held fixed.
//
//   bounce0_bwd_kernel  replaces mini_opencl_raytracer_tpu/ops/pallas/
//                       megakernel.py:_bounce0_bwd_kernel (K3): the VJP of
//                       the raygen-fused first bounce, through raygen into
//                       the camera vector.
//   bounce_bwd_kernel   replaces megakernel.py:_bounce_bwd_kernel (K4): the
//                       VJP of one bounce from the carried state, with the
//                       per-ray d(o, d, beta). With F_RESID (kResid; the
//                       JAX kernel under cfg.bwd_residuals) it reads the
//                       known-value rows K2 wrote instead of recomputing
//                       (below).
//
// The adjoint: ray_adjoint (adjoint.cuh), the VJP of one ray's bounce,
// shared with the wavefront's shading adjoint (shade_bwd.cu).
//
// The work. A persistent grid of G blocks (two per SM, fixed by the
// wrapper: ops/cuda/megakernel.py:bwd_plan) walks the tiles of 256 rays,
// block b taking tiles b, b + G, b + 2G, ..., kTilesPerStep at a time.
// Rays without a winner (dead, or missed: 64% at bounce 0, 93% at bounce 8
// of the main path) pass their cotangents through where the scan finds
// them; the others join the block's queue in ray order, and a round runs
// the adjoint whenever 256 are queued, so its warps are full of live rays
// however few there are. (A round per tile cost about as much at bounce 8
// as at bounce 1: the slowest warp's adjoint set each tile's time. Queueing
// every ray instead made K4 1.9x slower at bounce 8 and 16% slower at
// bounce 1 on the H100: PERF.md.)
//
// The sums over rays. The table [T_pad, 32], light [L, 16] and camera [16]
// gradients are sums over every ray. On the TPU the grid ran in order and
// summed in place; here blocks run in parallel, and the sums are built
// without atomics, so repeated runs on one card are bitwise equal:
//   * table: in each round, the rays of a warp that share a winner form a
//     group (__match_any_sync); the group's 28 gradient columns are summed
//     in registers by a pairwise tree over the members' rank in lane order
//     (step s adds rank r + s into rank r for r % 2s == 0); each group's
//     leader stages its sum in shared memory. The block then adds the
//     staged sums into its table partial, warp w taking the rows with
//     row % 8 == w, each row's sums in staging order (warp, then lane), one
//     lane per column. The partial lives in shared memory for T_pad <=
//     kSmemRows and in the block's slice of the global scratch above that
//     (same order, so both branches give the same bits);
//   * lights and camera: each light's (and the camera's) gradient is summed
//     over the warp by a butterfly of shuffles; lane 0 adds it to its
//     warp's row in shared memory, round after round; at the end the block
//     sums its warps' rows in warp order;
//   * each block writes its partial row ([T_pad * 32 + L * 16 (+ 16)]
//     floats) to the scratch; finish_kernel, the second and last launch,
//     sums the G rows of each column: 8 slices of the rows (slice k takes
//     rows k, k + 8, ...) in order, then a fixed pairwise tree over the
//     slices.
// Which ray lands in which round, lane and block follows from the data,
// the tile size and G only, never from timing; so does every sum's order.
//
// What bounds it. At the main path's 1080p bounce-1 state K4 must move
// 192 MB (chip_smoke.py:bwd_bytes, by ray class: a dead ray reads alive
// and three cotangents and writes d(o, d, beta), 76 B; an alive ray that
// misses adds its winner and the radiance cotangent, 92 B; a ray with a
// winner reads its state, winner and four cotangents, 132 B, plus its
// occlusion with shadow rays on; 92.5 B a ray on average; the table and
// lights in and out) and do 0.50 GFLOP (chip_smoke.py:ADJ_FLOPS, counted
// from this file), so its bound is 0.057 ms, set by bytes; K3's is 84 MB
// (32 B a miss, 56 B a ray with a winner) and 0.82 GFLOP, 0.025 ms. On
// the H100 (700 W) K4 takes 0.29 ms and K3 0.30, so their bounds are 20%
// and 8% of their times (PERF.md). What sets their time is the instructions each live ray issues (7.1-7.9k
// static SASS instructions a kernel, 116-127 of them calls of the IEEE
// divide and square-root routines, 1.8% transcendental: scripts/
// kernel_sass.py), on top of ~0.08-0.1 ms for the scan and the dead rays'
// pass-through, which runs near the memory rate.
//
// The residual variant (kResid). K2 with F_RESID stores, per ray with a
// winner, the values of its shading's transcendentals and of what the RNG
// draws alone decide (shade.cuh:shade, ops/known.py). K4 then
// reads, instead of computing: the lobe pick, the diffuse and specular
// draws' terms with their cos / sin / sqrt / exp / log (sample_brdf), the
// roughness sqrt, the winner's 1 / det, the soft-edge sigmoid, each
// light's distance, and with direct specular the Blinn-Phong power and the
// log of its base. It reads neither the seeds nor the draw counters, so it
// hashes no random number. The rows hold the bits the recompute would
// produce, and every adjoint formula is the recompute's (sqrt0_adj on the
// row's sin_h, the sigmoid's y (1 - y), 1 / det squared), so the gradients
// are bitwise the recompute's, but for one term: the power's derivative in
// the base, which the recompute takes as ex * pow(xb, ex - 1) and the
// variant as ex * y / xb from the row y (the JAX package's _k_pow), so
// with direct specular they differ by float rounding. The normalizes keep
// their sqrt: their adjoint needs the length itself (normalize_adj), and
// 1 / (the row) is not its bits. Every discrete decision replays bit for
// bit: the pick is a row, the ONB axis comes from the normal, the rest from
// the replayed values. It loads 1 / det, the pick and each light's rows,
// and 3 (diffuse) or 7 (Blinn specular) of its lobe: 8 a ray with a
// winner on average on Cornell. The rows sit in column rank[j] (K2's
// rank among the rays alive with a winner: a K2 tile's rays take
// consecutive columns in ray order), and the queue holds a block's rays
// with a winner in ray order, so a round's consecutive lanes read runs of
// consecutive columns. Where a round's rows fit in shared memory beside
// the rest (rows_in_smem: Cornell's 17 rows take 17 KB), each thread
// first loads its ray's written rows there, all at once, and the adjoint
// reads them from there (adjoint_round).
//
// Built with the forward kernels' flags (no fast-math, -fmad=false).

#include <cuda_pipeline.h>

#include "adjoint.cuh"
#include "raygen.cuh"

namespace {

constexpr int kCamGrads = 12;    // position, right, up, front
constexpr int kCamCols = 16;
constexpr int kStage = kRowGrads + 1;  // odd stride: no bank conflicts
// Largest T_pad whose table partial a block keeps in shared memory (must
// match ops/cuda/megakernel.py:_SMEM_ROWS).
constexpr int kSmemRows = 512;
// Tiles a block scans per step, and the ring of ray ids that holds what a
// step adds beside what the last round left (< kBlock).
constexpr int kTilesPerStep = 2;
constexpr int kQueue = kBlock * (kTilesPerStep + 1);

// The pointers of a backward launch (unused ones null).
struct BwdIO {
  const float *tab, *lights, *cam;
  const uint32_t* frame_cm;  // K3: premix of the frame, one word on the device
  const int* pixel_ids;
  const float *o, *d, *beta, *alive;
  const int *seeds, *winner, *occ;
  const float* resid;  // K4 with F_RESID: [n, R] known-value rows by rank (rows_of)
  const int* rank;     // K4 with F_RESID: [R] each ray's column of resid (K2's rank)
  const float *co, *cd, *cb, *cr;
  float *d_o, *d_d, *d_beta;
  float* part;  // [gridDim.x, part_cols] block partials
};

// Shared memory of a backward block; the table partial follows it when it
// lives in shared memory.
struct Smem {
  float lights[kMaxLights * kLightCols];
  float lg[kWarps * kMaxLights * kLightGrads];  // per-warp light gradients
  float cg[kWarps * kCamGrads];                 // per-warp camera gradients
  float stage[kBlock * kStage];                 // group sums of a tile
  int win[kBlock];                              // their rows, -1 if none
  int queue[kQueue];                            // ring of rays to differentiate
  int cnt[kTilesPerStep][kWarps];               // their count per warp, per tile
};

// Shared memory a block may take for two blocks to fit on an SM (228 KB,
// less 1 KB the system keeps a block).
constexpr size_t kSmemPerBlock = (228 - 2) * 1024 / 2;


__device__ __forceinline__ V3 ld_col(const float* a, int i, int R) {
  return mk(a[i], a[R + i], a[2 * R + i]);
}

__device__ __forceinline__ void st_col(float* a, int i, int R, V3 v) {
  a[i] = v.x;
  a[R + i] = v.y;
  a[2 * R + i] = v.z;
}

__device__ __forceinline__ Cot load_cot(const BwdIO& io, int i, int R) {
  return {ld_col(io.co, i, R), ld_col(io.cd, i, R), ld_col(io.cb, i, R), ld_col(io.cr, i, R)};
}

// The ray's winner; -1 for rays out of range and for indices outside the
// table (p.num_tris holds T_pad), so no kernel reads or writes past it.
__device__ __forceinline__ int load_winner(const MegaParams& p, const int* winner, int i) {
  if (i < 0 || i >= p.num_rays) return -1;
  const int w = winner[i];
  return w < p.num_tris ? w : -1;
}

// The adjoint of raygen (raygen.cuh) into the camera vector (position,
// right, up, front), added to cg.
__device__ __forceinline__ void raygen_adj(const Raygen& r, V3 g_o, V3 g_d,
                                           float (&cg)[kCamGrads]) {
  const V3 g_draw = normalize_adj(r.draw, g_d);
  const V3 parts[4] = {g_o, g_draw * r.x, g_draw * r.y, g_draw};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    cg[3 * j] += parts[j].x;
    cg[3 * j + 1] += parts[j].y;
    cg[3 * j + 2] += parts[j].z;
  }
}

// The group sums of this warp's table rows: rays with the same winner w >=
// 0 are summed by a pairwise tree in rank order; each group's leader (its
// lowest lane) stages the sum. Every lane of the warp calls it.
__device__ __forceinline__ void stage_groups(Smem& s, int w, float (&row)[kRowGrads]) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const unsigned grp = __match_any_sync(kFull, w >= 0 ? w : -1 - lane);
  const int rank = __popc(grp & below);
  const unsigned above = grp & ~below & ~(1u << lane);
  int nxt = above ? __ffs(above) - 1 : -1;  // the member of rank + st
  for (int st = 1; st < 32; st <<= 1) {
    const bool take = nxt >= 0 && (rank & (2 * st - 1)) == 0;
    if (!__any_sync(kFull, take)) break;
    const int src = nxt >= 0 ? nxt : lane;
#pragma unroll
    for (int c = 0; c < kRowGrads; ++c) {
      const float o = __shfl_sync(kFull, row[c], src);
      if (take) row[c] += o;
    }
    const int nn = __shfl_sync(kFull, nxt, src);
    nxt = nxt >= 0 ? nn : -1;
  }
  const bool lead = w >= 0 && rank == 0;
  s.win[threadIdx.x] = lead ? w : -1;
  if (lead) {
#pragma unroll
    for (int c = 0; c < kRowGrads; ++c) s.stage[threadIdx.x * kStage + c] = row[c];
  }
}

// Add the tile's staged group sums to the block's table partial: warp w
// takes the rows with row % kWarps == w, each row's sums in staging order,
// one lane per column.
__device__ __forceinline__ void merge_rows(const Smem& s, float* acc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int base = 0; base < kBlock; base += 32) {
    const int x = s.win[base + lane];
    unsigned own = __ballot_sync(kFull, x >= 0 && (x & (kWarps - 1)) == warp);
    while (own) {
      const int e = base + __ffs(own) - 1;
      own &= own - 1;
      if (lane < kRowGrads) acc[(size_t)s.win[e] * kTabCols + lane] += s.stage[e * kStage + lane];
    }
  }
}

__host__ __device__ __forceinline__ int part_cols(const MegaParams& p, bool first) {
  return p.num_tris * kTabCols + p.num_lights * kLightCols + (first ? kCamCols : 0);
}

// The camera gradient of a warp's lanes, summed over the warp and added to
// the warp's row (lane 0); cg is zeroed.
__device__ __forceinline__ void flush_cam(Smem& s, float (&cg)[kCamGrads]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kCamGrads; ++k) {
    const float v = warp_sum(cg[k]);
    if (lane == 0) s.cg[warp * kCamGrads + k] += v;
    cg[k] = 0.0f;
  }
}

// K4 with rows: whether a round's rows (n of them for each of kBlock rays)
// fit in shared memory beside the rest of a block's at two blocks an SM.
__host__ __device__ __forceinline__ bool rows_in_smem(const MegaParams& p, bool smem_tab) {
  const size_t tab = smem_tab ? (size_t)p.num_tris * kTabCols * sizeof(float) : 0;
  const size_t rows = (size_t)rows_of(p.flags, p.num_lights).n * kBlock * sizeof(float);
  return sizeof(Smem) + tab + rows <= kSmemPerBlock;
}

// One round: the adjoint of the n <= kBlock rays at the head of the queue
// (thread t takes entry t), their table rows summed into the block's
// partial, their light and camera gradients into the warps' rows.
// kResid: ``s_rows`` (null where they do not fit) holds column t of the
// round's rows for thread t: the thread copies its ray's written rows
// there through its rank with asynchronous copies (cp.async: no register
// holds them, and all are in flight at once; a loop of loads and stores
// waited on each load in turn, 13 latencies a round on Cornell), before the
// adjoint reads them one by one.
template <bool kFirst, bool kResid>
__device__ __forceinline__ void adjoint_round(const MegaParams& p, const BwdIO& io, Smem& s,
                                              float* acc, int head, int n, float* s_rows) {
  const int tid = threadIdx.x, warp = tid >> 5;
  const int R = p.num_rays;
  const int j = tid < n ? s.queue[(head + tid) % kQueue] : -1;
  float* lg = s.lg + warp * kMaxLights * kLightGrads;
  float row[kRowGrads];
#pragma unroll
  for (int k = 0; k < kRowGrads; ++k) row[k] = 0.0f;
  float cg[kCamGrads];
#pragma unroll
  for (int k = 0; k < kCamGrads; ++k) cg[k] = 0.0f;
  int w = -1;
  if (__any_sync(kFull, j >= 0)) {  // warps past the last ray skip it
    const bool in = j >= 0;
    Cot c = {zero3(), zero3(), zero3(), zero3()};
    if (in) c = load_cot(io, j, R);
    const int occ = in ? io.occ[j] : 0;
    const int win = load_winner(p, io.winner, j);
    V3 g_o, g_d, g_beta;
    if (kFirst) {
      Raygen r = {};
      if (in) r = raygen(p, io.cam, io.pixel_ids[j], *io.frame_cm);
      ray_adjoint<false>(p, s.lights, io.tab, r.o, r.d, mk(1.0f, 1.0f, 1.0f), in, r.seed, win,
                         occ, c, g_o, g_d, g_beta, row, lg, RowsIn{nullptr, 0, 0});
      if (in) raygen_adj(r, g_o, g_d, cg);
      w = in ? win : -1;
    } else {
      V3 o = zero3(), d = zero3(), beta = zero3();
      bool alive = false;
      uint32_t seed = 0;
      RowsIn rs = {io.resid, R, 0};
      if (in) {
        o = ld_col(io.o, j, R);
        d = ld_col(io.d, j, R);
        beta = ld_col(io.beta, j, R);
        alive = io.alive[j] > 0.0f;
        if (kResid) {  // the variant reads no seed
          rs.col = io.rank[j];
          if (s_rows) {  // asynchronous copies: every row's load in flight at once
            const Rows rl = rows_of(p.flags, p.num_lights);
            for (int k = 0; k < rl.n; ++k)
              if (row_written(rl, k, p.flags))
                __pipeline_memcpy_async(s_rows + k * kBlock + tid,
                                        &rs.base[(size_t)k * R + rs.col], sizeof(float));
            __pipeline_commit();
            __pipeline_wait_prior(0);
            rs = {s_rows, kBlock, tid};
          }
        } else {
          seed = (uint32_t)io.seeds[j];
        }
      }
      ray_adjoint<kResid>(p, s.lights, io.tab, o, d, beta, alive, seed, win, occ, c, g_o, g_d,
                          g_beta, row, lg, rs);
      if (in) {
        st_col(io.d_o, j, R, g_o);
        st_col(io.d_d, j, R, g_d);
        st_col(io.d_beta, j, R, g_beta);
      }
      w = alive ? win : -1;
    }
  }
  stage_groups(s, w, row);
  if (kFirst) flush_cam(s, cg);
  __syncthreads();
  merge_rows(s, acc);
  __syncthreads();
}

// The body of both backward kernels: kFirst selects K3 (raygen from pixel
// ids, camera gradient) or K4 (carried state, per-ray d(o, d, beta));
// kSmemTab puts the block's table partial in shared memory; kResid (K4
// only) reads the known-value rows.
//
// Block b scans its tiles b, b + G, b + 2G, ... kTilesPerStep at a time.
// Rays without a winner (dead or missed) pass their cotangents through
// where the scan finds them, and the others join the queue in ray order.
// Whenever the queue holds
// kBlock rays a round differentiates them, and a last round takes the
// rest, so the warps that run the adjoint are full of live rays however
// few there are.
template <bool kFirst, bool kSmemTab, bool kResid>
__device__ __forceinline__ void bwd_body(const MegaParams& p, const BwdIO& io) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int R = p.num_rays, L = p.num_lights, G = gridDim.x;
  const int n_tab = p.num_tris * kTabCols;
  float* part = io.part + (size_t)blockIdx.x * part_cols(p, kFirst);
  float* acc = kSmemTab ? reinterpret_cast<float*>(smem_raw + sizeof(Smem)) : part;
  float* s_rows = kResid && rows_in_smem(p, kSmemTab)
                      ? reinterpret_cast<float*>(smem_raw + sizeof(Smem)) +
                            (kSmemTab ? n_tab : 0)
                      : nullptr;
  for (int k = tid; k < L * kLightCols; k += kBlock) s.lights[k] = io.lights[k];
  for (int k = tid; k < kWarps * kMaxLights * kLightGrads; k += kBlock) s.lg[k] = 0.0f;
  for (int k = tid; k < kWarps * kCamGrads; k += kBlock) s.cg[k] = 0.0f;
  for (int k = tid; k < n_tab; k += kBlock) acc[k] = 0.0f;
  __syncthreads();
  const V3 sky = mk(p.sky[0], p.sky[1], p.sky[2]);
  const int tiles = (R + kBlock - 1) / kBlock;
  const unsigned below = (1u << lane) - 1u;
  int head = 0, count = 0;  // the queue, the same in every thread

  for (int t0 = blockIdx.x;; t0 += kTilesPerStep * G) {
    const bool last = t0 >= tiles;  // then the rounds take what is left
    if (!last) {
      float cg[kCamGrads];
#pragma unroll
      for (int k = 0; k < kCamGrads; ++k) cg[k] = 0.0f;
      unsigned took[kTilesPerStep];
#pragma unroll
      for (int m = 0; m < kTilesPerStep; ++m) {
        const int tile = t0 + m * G;
        const int i = tile * kBlock + tid;
        const bool in = tile < tiles && i < R;
        const bool alive_i = in && (kFirst || io.alive[i] > 0.0f);
        const bool live_i = alive_i && load_winner(p, io.winner, i) >= 0;
        if (in && !live_i) {
          const Cot c = load_cot(io, i, R);
          if (kFirst) {
            raygen_adj(raygen(p, io.cam, io.pixel_ids[i], *io.frame_cm), c.o, c.d, cg);
          } else {
            st_col(io.d_o, i, R, c.o);
            st_col(io.d_d, i, R, c.d);
            st_col(io.d_beta, i, R, alive_i ? c.beta + c.rad * sky : c.beta);
          }
        }
        took[m] = __ballot_sync(kFull, live_i);
        if (lane == 0) s.cnt[m][warp] = __popc(took[m]);
      }
      if (kFirst) flush_cam(s, cg);
      __syncthreads();
      int end = head + count;
#pragma unroll
      for (int m = 0; m < kTilesPerStep; ++m) {
        int mine = end;
        for (int w = 0; w < kWarps; ++w) {
          const int k = s.cnt[m][w];
          mine = w == warp ? end : mine;
          end += k;
        }
        if ((took[m] >> lane) & 1u)
          s.queue[(mine + __popc(took[m] & below)) % kQueue] = (t0 + m * G) * kBlock + tid;
      }
      count = end - head;
      __syncthreads();
    }
    // Full rounds, and at the end what is left. One call site, so the
    // adjoint is inlined once (two sites doubled the spill).
    for (;;) {
      const int n = count >= kBlock ? kBlock : last ? count : 0;
      if (n == 0) break;
      adjoint_round<kFirst, kResid>(p, io, s, acc, head, n, s_rows);
      head += n;
      count -= n;
    }
    if (last) break;
  }

  // The block's partial row: table, lights and camera, each summed over
  // the warps in warp order.
  if (kSmemTab)
    for (int k = tid; k < n_tab; k += kBlock) part[k] = acc[k];
  for (int k = tid; k < L * kLightCols; k += kBlock) {
    const int li = k / kLightCols, c = k % kLightCols;
    float v = 0.0f;
    if (c < kLightGrads)
      for (int w = 0; w < kWarps; ++w) v += s.lg[(w * kMaxLights + li) * kLightGrads + c];
    part[n_tab + k] = v;
  }
  if (kFirst && tid < kCamCols) {
    float v = 0.0f;
    if (tid < kCamGrads)
      for (int w = 0; w < kWarps; ++w) v += s.cg[w * kCamGrads + tid];
    part[n_tab + L * kLightCols + tid] = v;
  }
}

template <bool kSmemTab>
__global__ void __launch_bounds__(kBlock, 2)
bounce0_bwd_kernel(MegaParams p, BwdIO io) {
  bwd_body<true, kSmemTab, false>(p, io);
}

template <bool kSmemTab, bool kResid>
__global__ void __launch_bounds__(kBlock, 2)
bounce_bwd_kernel(MegaParams p, BwdIO io) {
  bwd_body<false, kSmemTab, kResid>(p, io);
}


using BwdKernel = void(MegaParams, BwdIO);

template <BwdKernel* kKernel>
cudaError_t launch_bwd(const MegaParams& p, const BwdIO& io, int grid, bool smem_tab,
                       cudaStream_t st) {
  // Once per kernel: allow the table, and K4 with rows its staged rows, in
  // shared memory.
  static bool ready = false;
  const bool resid = p.flags & F_RESID;
  if (!ready) {
    size_t most = sizeof(Smem) + (size_t)kSmemRows * kTabCols * sizeof(float);
    if (resid && most < kSmemPerBlock) most = kSmemPerBlock;
    const cudaError_t e =
        cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  size_t bytes = sizeof(Smem) + (smem_tab ? (size_t)p.num_tris * kTabCols * sizeof(float) : 0);
  if (resid && rows_in_smem(p, smem_tab))
    bytes += (size_t)rows_of(p.flags, p.num_lights).n * kBlock * sizeof(float);
  kKernel<<<grid, kBlock, bytes, st>>>(p, io);
  return cudaGetLastError();
}

cudaError_t finish(const MegaParams& p, bool first, int grid, const float* part, float* d_tab,
                   float* d_lights, float* d_cam, cudaStream_t st) {
  const int n = part_cols(p, first);
  finish_kernel<<<(n + 31) / 32, kBlock, 0, st>>>(part, grid, n, p.num_tris * kTabCols,
                                                  p.num_lights * kLightCols, d_tab, d_lights,
                                                  d_cam);
  return cudaGetLastError();
}

int check_args(const MegaParams* p, int grid, int smem_tab) {
  if (p->num_lights > kMaxLights || grid < 1 || (smem_tab && p->num_tris > kSmemRows) ||
      (p->flags & ~kKnownFlags))
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

}  // namespace

// C entry points (ops/cuda/build.py). p->num_tris holds T_pad, the table's
// row count; `grid` is the number of persistent blocks and `part` their
// [grid, T_pad * 32 + L * 16 (+ 16)] partials, written whole by the first
// launch (the wrapper allocates it with torch.empty); `smem_table` keeps
// each block's table partial in shared memory (T_pad <= kSmemRows). Each
// launches two kernels on the given stream, does not synchronise, and
// returns the first cudaError_t that is not cudaSuccess. mrt_bounce_bwd's
// resid and rank: the [n, R] rows K2 wrote and each ray's column of them,
// with F_RESID (then seeds may be null), else null.
extern "C" int mrt_bounce0_bwd(const MegaParams* p, int grid, int smem_table,
                               const uint32_t* frame_cm, const float* tab, const float* lights,
                               const float* cam, const int* pixel_ids, const int* winner,
                               const int* occ,
                               const float* co, const float* cd, const float* cb, const float* cr,
                               float* part, float* d_tab, float* d_lights, float* d_cam,
                               void* stream) {
  if (p->num_rays <= 0) return 0;
  const int bad = check_args(p, grid, smem_table);
  if (bad) return bad;
  if (p->flags & F_RESID) return (int)cudaErrorInvalidValue;  // K3 has no residual mode
  const cudaStream_t st = (cudaStream_t)stream;
  BwdIO io = {};
  io.tab = tab;
  io.lights = lights;
  io.cam = cam;
  io.frame_cm = frame_cm;
  io.pixel_ids = pixel_ids;
  io.winner = winner;
  io.occ = occ;
  io.co = co;
  io.cd = cd;
  io.cb = cb;
  io.cr = cr;
  io.part = part;
  const cudaError_t e = smem_table
      ? launch_bwd<bounce0_bwd_kernel<true>>(*p, io, grid, true, st)
      : launch_bwd<bounce0_bwd_kernel<false>>(*p, io, grid, false, st);
  if (e != cudaSuccess) return (int)e;
  return (int)finish(*p, true, grid, part, d_tab, d_lights, d_cam, st);
}

extern "C" int mrt_bounce_bwd(const MegaParams* p, int grid, int smem_table,
                              const float* tab, const float* lights, const float* o,
                              const float* d, const float* beta, const float* alive,
                              const int* seeds, const int* winner, const int* occ,
                              const float* co, const float* cd, const float* cb, const float* cr,
                              float* part, float* d_o, float* d_d, float* d_beta, float* d_tab,
                              float* d_lights, const float* resid, const int* rank,
                              void* stream) {
  if (p->num_rays <= 0) return 0;
  const int bad = check_args(p, grid, smem_table);
  if (bad) return bad;
  const bool res = p->flags & F_RESID;
  if (res ? !(resid && rank) : !seeds) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  BwdIO io = {};
  io.tab = tab;
  io.lights = lights;
  io.o = o;
  io.d = d;
  io.beta = beta;
  io.alive = alive;
  io.seeds = seeds;
  io.winner = winner;
  io.occ = occ;
  io.co = co;
  io.cd = cd;
  io.cb = cb;
  io.cr = cr;
  io.d_o = d_o;
  io.d_d = d_d;
  io.d_beta = d_beta;
  io.resid = resid;
  io.rank = rank;
  io.part = part;
  const cudaError_t e =
      res ? (smem_table ? launch_bwd<bounce_bwd_kernel<true, true>>(*p, io, grid, true, st)
                        : launch_bwd<bounce_bwd_kernel<false, true>>(*p, io, grid, false, st))
          : (smem_table ? launch_bwd<bounce_bwd_kernel<true, false>>(*p, io, grid, true, st)
                        : launch_bwd<bounce_bwd_kernel<false, false>>(*p, io, grid, false, st));
  if (e != cudaSuccess) return (int)e;
  return (int)finish(*p, false, grid, part, d_tab, d_lights, nullptr, st);
}
