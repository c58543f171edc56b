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
//                       per-ray d(o, d, beta).
//
// The adjoint. The TPU kernels run jax.vjp of a replay inside the kernel.
// Here it is written by hand, one thread per ray: ray_adjoint replays the
// forward bounce in the plain version's operation order (the expressions of
// bounce_body in megakernel.cu, so every discrete decision -- pick_spec,
// the ONB axis, same_hemi, valid, ok, the light type, the spot branch --
// replays bit for bit), then runs the adjoint back through direct light,
// the BRDF lobe (Schlick / Smith / NDF, Blinn exp-log or GGX sqrt
// sampling), the ONB, the normalizes and the (t, u, v) recompute on the
// winner's table row (v0, e1, e2 in columns 0-8, megakernel.py:
// _winner_point). Rays not alive, and live rays whose path ends here, pass
// their (o, d, beta) cotangents through (megakernel.py:1001, 1015-1016).
// RNG draws carry no gradient. Where max / min / clamp tie, each side takes
// half the gradient, as jnp.maximum and jnp.clip do. sin(theta_h) =
// sqrt(max(1 - cos^2, 0)) takes zero gradient at 0, as ops/brdf.py's plain
// version does (there the JAX package's gradient is inf or NaN).
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
// Registers. The replay's values are not held across the light loop's
// adjoint: the BRDF sample and the winner point are replayed a second time
// where their adjoints need them, from inputs passed through opaque() so
// the compiler cannot merge the two replays back into long live ranges.
// __launch_bounds__(kBlock, 2) caps a thread at 128 registers, so two
// 256-thread blocks (16 warps) fit on an SM; ptxas spills 148-168 bytes a
// thread. Without the cap (159-165 registers, no spill, one block per SM)
// K4 took 42% longer at bounce 1 on the H100.
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
// Built with the forward kernels' flags (no fast-math, -fmad=false).

#include "megakernel.cuh"

namespace {

constexpr int kRowGrads = 28;    // differentiable table columns, v0 .. ns
constexpr int kLightGrads = 10;  // light columns 0-9 (type gets zero)
constexpr int kCamGrads = 12;    // position, right, up, front
constexpr int kCamCols = 16;
constexpr int kMaxLights = 30;
constexpr int kWarps = kBlock / 32;
constexpr int kStage = kRowGrads + 1;  // odd stride: no bank conflicts
// Largest T_pad whose table partial a block keeps in shared memory (must
// match ops/cuda/megakernel.py:_SMEM_ROWS).
constexpr int kSmemRows = 512;
constexpr unsigned kFull = 0xffffffffu;
// Tiles a block scans per step, and the ring of ray ids that holds what a
// step adds beside what the last round left (< kBlock).
constexpr int kTilesPerStep = 2;
constexpr int kQueue = kBlock * (kTilesPerStep + 1);

struct Cot {
  V3 o, d, beta, rad;
};

// The pointers of a backward launch (unused ones null).
struct BwdIO {
  const float *tab, *lights, *cam;
  const int* pixel_ids;
  const float *o, *d, *beta, *alive;
  const int *seeds, *winner, *occ;
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

__device__ __forceinline__ V3 zero3() { return mk(0.0f, 0.0f, 0.0f); }

// A value the compiler must treat as new: the replays below are computed
// again instead of held in registers across the light loop.
__device__ __forceinline__ float opaque(float x) {
#ifdef __CUDA_ARCH__
  asm volatile("" : "+f"(x));
#endif
  return x;
}
__device__ __forceinline__ V3 opaque(V3 a) { return mk(opaque(a.x), opaque(a.y), opaque(a.z)); }
__device__ __forceinline__ const float* opaque(const float* ptr) {
  unsigned long long bits = reinterpret_cast<unsigned long long>(ptr);
#ifdef __CUDA_ARCH__
  asm volatile("" : "+l"(bits));
#endif
  return reinterpret_cast<const float*>(bits);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Adjoint of n = normalize(a) = a * (1 / sqrt(max(a.a, 1e-20))).
__device__ __forceinline__ V3 normalize_adj(V3 a, V3 g) {
  const float q = dot(a, a);
  const float r = sqrtf(fmaxf(q, 1e-20f));
  const float inv = 1.0f / r;
  const float g_r = -dot(g, a) * inv * inv;
  const float g_q = dmax(q, 1e-20f) * (g_r / (2.0f * r));
  return g * inv + a * (2.0f * g_q);
}

// Adjoint of s = sqrt(x) for x >= 0, zero at x == 0 (ops/brdf._sqrt0).
__device__ __forceinline__ float sqrt0_adj(float x, float s, float g) {
  return x > 0.0f ? g / (2.0f * s) : 0.0f;
}

// Adjoint of clamp(x, 0, 1) = min(max(x, 0), 1) with halves at the bounds.
__device__ __forceinline__ float clip01_adj(float x, float g) {
  return dmax(x, 0.0f) * dmin(fmaxf(x, 0.0f), 1.0f) * g;
}

// The winner point on the table row (megakernel.py:_winner_point), as
// bounce_body computes it.
struct Hit {
  V3 pvec, tvec, qvec, pos, nraw, normal;
  float det, inv, u, v, t, cov;
  bool dvalid, tvalid;
};

__device__ __forceinline__ Hit winner_point(const MegaParams& p, const float* row, V3 o, V3 d) {
  Hit h;
  const V3 v0 = ld3(row + kV0), e1 = ld3(row + kE1), e2 = ld3(row + kE2);
  h.pvec = cross(d, e2);
  h.det = dot(e1, h.pvec);
  h.dvalid = (p.flags & F_CULL) ? h.det > kDetEps : fabsf(h.det) > kDetEps;
  h.inv = h.dvalid ? 1.0f / h.det : 0.0f;
  h.tvec = o - v0;
  h.u = dot(h.tvec, h.pvec) * h.inv;
  h.qvec = cross(h.tvec, e1);
  h.v = dot(d, h.qvec) * h.inv;
  const float t_raw = dot(e2, h.qvec) * h.inv;
  h.tvalid = h.dvalid && h.u >= 0.0f && h.v >= 0.0f && h.u + h.v <= 1.0f && t_raw > 0.0f;
  h.t = h.tvalid ? t_raw : kBig;
  const float w = 1.0f - h.u - h.v;
  h.pos = o + d * h.t;
  h.nraw = h.u * ld3(row + kN1) + h.v * ld3(row + kN2) + w * ld3(row + kN0);
  h.normal = normalize(h.nraw);
  h.cov = 1.0f;
  if (p.flags & F_SOFT) {
    const float margin = fminf(fminf(h.u, h.v), 1.0f - h.u - h.v);
    h.cov = 1.0f / (1.0f + expf(-(margin * p.inv_soft_sigma)));
  }
  return h;
}

// The BRDF sample of bounce_body and every value its adjoint reads.
struct Brdf {
  V3 craw, tt, ss, wraw, wi, f, whraw, wh;
  bool pick_spec, valid;
  float cphi, sphi, cp, sp, cos_t, pdf;
  float alpha, log_u2, a1, cos_h, sin_h, sh2, cosn, d_ndf, pdf_h, rough, a_g, a2;
  float u2c, den, cos_h2, dd, ddm;
  float c_wowh, cos_i, cos_o, wdw, pm, rr, k, dnv, dnl, ndotv, ndotl, Dv, Dl;
  float g1v, g1l, G, xf, x2, fr, mi, mo, denom, num, scale;
};

__device__ __forceinline__ Brdf sample_brdf(const MegaParams& p, uint32_t seed, V3 normal, V3 wo,
                                            V3 kd, V3 ks, float ns) {
  Brdf b = {};
  b.pick_spec = uniform_cm(seed, p.cms[0]) > p.spec_threshold;
  const bool use_y = fabsf(normal.x) > 1e-3f;
  const V3 axis = use_y ? mk(0.0f, 1.0f, 0.0f) : mk(1.0f, 0.0f, 0.0f);
  b.craw = cross(axis, normal);
  b.tt = normalize(b.craw);
  b.ss = cross(normal, b.tt);
  if (!b.pick_spec) {
    const float du1 = uniform_cm(seed, p.cms[1]);
    const float du2 = uniform_cm(seed, p.cms[2]);
    const float phi = kTwoPi * du1;
    const float sin_t = sqrtf(du2);
    b.cos_t = sqrtf(fmaxf(1.0f - du2, 0.0f));
    b.cphi = cosf(phi);
    b.sphi = sinf(phi);
    b.cp = b.cphi * sin_t;
    b.sp = b.sphi * sin_t;
    b.wraw = b.ss * b.cp + b.tt * b.sp + normal * b.cos_t;
    b.wi = normalize(b.wraw);
    b.pdf = dot(b.wi, normal) * kInvPi;
    b.f = kd * kInvPi;
    b.valid = b.pdf > 0.0f;
    return b;
  }
  const float su1 = uniform_cm(seed, p.cms[3]);
  const float su2 = uniform_cm(seed, p.cms[4]);
  const float phi = kTwoPi * su1;
  b.cphi = cosf(phi);
  b.sphi = sinf(phi);
  b.alpha = fmaxf(ns, 0.0f);
  if (p.flags & F_GGX) {
    b.rough = sqrtf(2.0f / (b.alpha + 2.0f));
    b.a_g = b.rough * b.rough;
    b.a2 = fmaxf(b.a_g * b.a_g, 1e-12f);
    b.u2c = clampf(su2, 0.0f, 1.0f - 1e-7f);
    b.den = 1.0f + (b.a2 - 1.0f) * b.u2c;
    b.cos_h2 = (1.0f - b.u2c) / b.den;
    b.cos_h = sqrtf(clampf(b.cos_h2, 0.0f, 1.0f));
    b.sh2 = fmaxf(1.0f - b.cos_h2, 0.0f);
    b.sin_h = sqrtf(b.sh2);
    b.dd = b.cos_h2 * (b.a2 - 1.0f) + 1.0f;
    b.ddm = fmaxf(b.dd * b.dd, 1e-12f);
    b.d_ndf = b.a2 * kInvPi / b.ddm;
    b.pdf_h = b.d_ndf * b.cos_h;
  } else {
    b.log_u2 = logf(clampf(su2, 1e-12f, 1.0f));
    b.a1 = b.alpha + 1.0f;
    b.cos_h = expf(b.log_u2 / b.a1);
    b.sh2 = fmaxf(1.0f - b.cos_h * b.cos_h, 0.0f);
    b.sin_h = sqrtf(b.sh2);
    b.cosn = expf(b.log_u2 * (b.alpha / b.a1));
    b.d_ndf = (b.alpha + 2.0f) * kHalfInvPi * b.cosn;
    b.pdf_h = (b.alpha + 1.0f) * kHalfInvPi * b.cosn;
    b.rough = sqrtf(2.0f / (b.alpha + 2.0f));
  }
  b.cp = b.cphi * b.sin_h;
  b.sp = b.sphi * b.sin_h;
  b.whraw = b.ss * b.cp + b.tt * b.sp + normal * b.cos_h;
  b.wh = normalize(b.whraw);
  b.c_wowh = dot(wo, b.wh);
  b.wi = -wo + (2.0f * b.c_wowh) * b.wh;
  b.cos_i = dot(b.wi, normal);
  b.cos_o = dot(wo, normal);
  const bool same_hemi = b.cos_i * b.cos_o >= 1e-6f;
  b.wdw = fmaxf(b.c_wowh, 0.0f);
  b.pm = fmaxf(4.0f * b.wdw, 1e-8f);
  b.pdf = b.pdf_h / b.pm;
  b.rr = b.rough + 1.0f;
  b.k = (b.rr * b.rr) / 8.0f;
  b.dnv = dot(normal, wo);
  b.ndotv = fmaxf(b.dnv, 0.0f);
  b.dnl = dot(normal, b.wi);
  b.ndotl = fmaxf(b.dnl, 0.0f);
  b.Dv = b.ndotv * (1.0f - b.k) + b.k;
  b.Dl = b.ndotl * (1.0f - b.k) + b.k;
  b.g1v = b.ndotv / b.Dv;
  b.g1l = b.ndotl / b.Dl;
  b.G = b.g1v * b.g1l;
  b.xf = fmaxf(1.0f - b.wdw, 0.0f);
  b.x2 = b.xf * b.xf;
  b.fr = 0.04f + 0.96f * (b.x2 * b.x2 * b.xf);
  b.mi = fmaxf(b.cos_i, 0.0f);
  b.mo = fmaxf(b.cos_o, 0.0f);
  b.denom = 4.0f * b.mi * b.mo + 1e-3f;
  b.num = b.d_ndf * b.G * b.fr;
  b.scale = b.num / b.denom;
  b.valid = same_hemi && b.pdf > 0.0f && b.wdw > 0.0f;
  b.f = b.valid ? ks * b.scale : zero3();
  return b;
}

// VJP of one bounce of one ray (bounce_body replayed with the winner and
// the occlusion bits frozen). Every lane of the warp calls it (rays out of
// range with alive = false): the light loop reduces across the warp.
// Returns d(o, d, beta); fills row with the winner row's 28 gradient
// columns when the ray is alive and has a winner; adds each light's 10
// gradient columns, summed over the warp, to lg[li * 10 + k] (lane 0).
__device__ __forceinline__ void ray_adjoint(const MegaParams& p, const float* s_lights,
                                            const float* __restrict__ tab, V3 o, V3 d, V3 beta,
                                            bool alive, uint32_t seed, int winner, int occ,
                                            const Cot& c, V3& g_o, V3& g_d, V3& g_beta,
                                            float (&row)[kRowGrads], float* lg) {
  const bool soft = p.flags & F_SOFT;
  const bool dspec = p.flags & F_DSPEC;
  const bool shadow = p.flags & F_SHADOW;
  const V3 sky = mk(p.sky[0], p.sky[1], p.sky[2]);
  const bool live = alive && winner >= 0;
  const float* trow = tab + (size_t)(live ? winner : 0) * kTabCols;
  const V3 wo = -d;

  // ------------------------------------------------- replay (what the head
  // of the adjoint and the light loop read; the rest is replayed below)
  V3 pos = zero3(), normal = zero3(), kd = zero3(), ks = zero3(), wi = zero3(), f = zero3();
  V3 mul = zero3();
  float ns = 0.0f, cov = 1.0f, cos_i2 = 0.0f, pdf_safe = 1.0f;
  bool lo = false;
  if (live) {
    const Hit h = winner_point(p, trow, o, d);
    pos = h.pos;
    normal = h.normal;
    cov = h.cov;
    kd = ld3(trow + kKD);
    ks = ld3(trow + kKS);
    ns = trow[kNS];
    const Brdf b = sample_brdf(p, seed, normal, wo, kd, ks, ns);
    wi = b.wi;
    f = b.f;
    cos_i2 = dot(wi, normal);
    pdf_safe = b.pdf > 0.0f ? b.pdf : 1.0f;
    mul = f * (cos_i2 / pdf_safe);
    lo = b.valid && b.pdf > 0.0f && isfinite(mul.x) && isfinite(mul.y) && isfinite(mul.z);
  }

  // Direct light weights (the forward's light loop, occlusion replayed).
  float diff_w = 0.0f, spec_w = 0.0f;
  if (lo) {
    for (int li = 0; li < p.num_lights; ++li) {
      const float* lrow = s_lights + kLightCols * li;
      const bool blocked = shadow && ((occ >> li) & 1);
      if (blocked) continue;
      const V3 ldir = normalize(ld3(lrow + kLDir));
      const int ltype = (int)rintf(lrow[kLType]);
      const V3 to_l = ld3(lrow + kLPos) - pos;
      const float dist = sqrtf(fmaxf(dot(to_l, to_l), 1e-12f));
      const bool is_dir = ltype <= 0;
      const V3 l_unit = is_dir ? -ldir : mk(to_l.x / dist, to_l.y / dist, to_l.z / dist);
      const float ndl = fmaxf(dot(normal, l_unit), 0.0f);
      float attn = is_dir ? 1.0f : 1.0f / fmaxf(lrow[kLAtt] * dist * dist, 1e-6f);
      if (ltype >= 2) {
        const float cos_cut = lrow[kLCut];
        const float cos_angle = dot(-l_unit, ldir);
        attn = attn * clampf((cos_angle - cos_cut) / fmaxf(1.0f - cos_cut, 1e-6f), 0.0f, 1.0f);
      }
      diff_w += attn * lrow[kLInt] * ndl;
      if (dspec) {
        const V3 h = normalize(l_unit + wo);
        const float ndoth = fmaxf(dot(normal, h), 0.0f);
        float spec = powf(fmaxf(ndoth, 1e-6f), fmaxf(ns, 1.0f));
        spec = ndl > 0.0f ? spec : 0.0f;
        spec_w += attn * lrow[kLInt] * spec;
      }
    }
  }

  // --------------------------------------------------------------- adjoint
  // Pass-through: rays not alive, misses and ended paths keep (o, d, beta).
  g_o = lo ? zero3() : c.o;
  g_d = lo ? zero3() : c.d;
  g_beta = lo ? zero3() : c.beta;
  if (alive && winner < 0) g_beta = g_beta + c.rad * sky;  // miss: beta * sky

  V3 g_pos = zero3(), g_normal = zero3(), g_wo = zero3(), g_wi = zero3();
  V3 g_kd = zero3(), g_ks = zero3(), g_f = zero3();
  float g_ns = 0.0f, g_cov = 0.0f, g_diff_w = 0.0f, g_spec_w = 0.0f, g_pdf = 0.0f;

  if (lo) {
    // o' = pos + wi * eps, d' = wi (kernel_bvh.cl:380).
    g_pos = c.o;
    g_wi = c.o * p.ray_eps + c.d;
    // radiance += (cov * direct) * beta_new, beta_new = beta * mul.
    const V3 beta_new = beta * mul;
    V3 direct = diff_w * kd;
    if (dspec) direct = direct + spec_w * ks;
    const V3 g_beta_new = c.beta + c.rad * (cov * direct);
    const V3 g_cd = c.rad * beta_new;
    const V3 g_direct = g_cd * cov;
    g_cov += dot(g_cd, direct);
    g_diff_w = dot(g_direct, kd);
    g_kd = g_kd + g_direct * diff_w;
    if (dspec) {
      g_spec_w = dot(g_direct, ks);
      g_ks = g_ks + g_direct * spec_w;
    }
    // mul = f * (cos_i2 / pdf).
    g_beta = g_beta_new * mul;
    const V3 g_mul = g_beta_new * beta;
    const float sc = cos_i2 / pdf_safe;
    g_f = g_mul * sc;
    const float g_sc = dot(g_mul, f);
    const float g_cos_i2 = g_sc / pdf_safe;
    g_pdf = -g_sc * cos_i2 / (pdf_safe * pdf_safe);
    g_wi = g_wi + normal * g_cos_i2;
    g_normal = g_normal + wi * g_cos_i2;
  }

  // Lights, in a loop every lane runs: each light's gradient is summed over
  // the warp, and lane 0 adds it to the warp's row. A light no lane of the
  // warp sees is skipped.
  const int lane = threadIdx.x & 31;
  for (int li = 0; li < p.num_lights; ++li) {
    const bool blocked = shadow && ((occ >> li) & 1);
    if (!__any_sync(kFull, lo && !blocked)) continue;
    float lg_ray[kLightGrads];
#pragma unroll
    for (int j = 0; j < kLightGrads; ++j) lg_ray[j] = 0.0f;
    const float* lrow = s_lights + kLightCols * li;
    if (lo && !blocked) {
      const V3 ldraw = ld3(lrow + kLDir);
      const V3 ldir = normalize(ldraw);
      const int ltype = (int)rintf(lrow[kLType]);
      const float intensity = lrow[kLInt];
      const float falloff = lrow[kLAtt];
      const float cos_cut = lrow[kLCut];
      const V3 to_l = ld3(lrow + kLPos) - pos;
      const float dq = dot(to_l, to_l);
      const float dist = sqrtf(fmaxf(dq, 1e-12f));
      const bool is_dir = ltype <= 0;
      const V3 l_unit = is_dir ? -ldir : mk(to_l.x / dist, to_l.y / dist, to_l.z / dist);
      const float nd = dot(normal, l_unit);
      const float ndl = fmaxf(nd, 0.0f);
      const float F = falloff * dist * dist;
      const float attn0 = is_dir ? 1.0f : 1.0f / fmaxf(F, 1e-6f);
      const bool spot = ltype >= 2;
      float attn = attn0, ca = 0.0f, cc = 1.0f, swr = 0.0f, spot_w = 1.0f;
      if (spot) {
        ca = dot(-l_unit, ldir);
        cc = fmaxf(1.0f - cos_cut, 1e-6f);
        swr = (ca - cos_cut) / cc;
        spot_w = clampf(swr, 0.0f, 1.0f);
        attn = attn0 * spot_w;
      }
      const float ai = attn * intensity;
      float g_ai = g_diff_w * ndl;
      float g_ndl = g_diff_w * ai;
      V3 g_lu = zero3();
      if (dspec) {
        const V3 hraw = l_unit + wo;
        const V3 h = normalize(hraw);
        const float nh = dot(normal, h);
        const float ndoth = fmaxf(nh, 0.0f);
        const float xb = fmaxf(ndoth, 1e-6f);
        const float ex = fmaxf(ns, 1.0f);
        const float spec_p = powf(xb, ex);
        const float spec = ndl > 0.0f ? spec_p : 0.0f;
        g_ai += g_spec_w * spec;
        if (ndl > 0.0f) {
          const float g_spec = g_spec_w * ai;
          const float g_xb = g_spec * (ex * powf(xb, ex - 1.0f));
          g_ns += dmax(ns, 1.0f) * (g_spec * (spec_p * logf(xb)));
          const float g_nh = dmax(nh, 0.0f) * dmax(ndoth, 1e-6f) * g_xb;
          g_normal = g_normal + h * g_nh;
          const V3 g_hraw = normalize_adj(hraw, normal * g_nh);
          g_lu = g_lu + g_hraw;
          g_wo = g_wo + g_hraw;
        }
      }
      const float g_attn = g_ai * intensity;
      lg_ray[kLInt] = g_ai * attn;
      const float g_nd = dmax(nd, 0.0f) * g_ndl;
      g_normal = g_normal + l_unit * g_nd;
      g_lu = g_lu + normal * g_nd;
      V3 g_ldir = zero3();
      float g_attn0 = g_attn;
      if (spot) {
        g_attn0 = g_attn * spot_w;
        const float g_swr = clip01_adj(swr, g_attn * attn0);
        const float g_ca = g_swr / cc;
        const float g_cc = -g_swr * (ca - cos_cut) / (cc * cc);
        lg_ray[kLCut] = -g_swr / cc - dmax(1.0f - cos_cut, 1e-6f) * g_cc;
        g_lu = g_lu - ldir * g_ca;
        g_ldir = g_ldir - l_unit * g_ca;
      }
      float g_dist = 0.0f;
      V3 g_to_l = zero3();
      if (is_dir) {
        g_ldir = g_ldir - g_lu;
      } else {
        const float g_F = dmax(F, 1e-6f) * (-g_attn0 * attn0 * attn0);
        const float g_fd = g_F * dist;
        g_dist += g_F * (falloff * dist) + g_fd * falloff;
        lg_ray[kLAtt] = g_fd * dist;
        g_to_l = mk(g_lu.x / dist, g_lu.y / dist, g_lu.z / dist);
        g_dist -= dot(g_lu, to_l) / (dist * dist);
        const float g_dq = dmax(dq, 1e-12f) * (g_dist / (2.0f * dist));
        g_to_l = g_to_l + to_l * (2.0f * g_dq);
        g_pos = g_pos - g_to_l;
      }
      lg_ray[kLPos] = g_to_l.x;
      lg_ray[kLPos + 1] = g_to_l.y;
      lg_ray[kLPos + 2] = g_to_l.z;
      const V3 g_ldraw = normalize_adj(ldraw, g_ldir);
      lg_ray[kLDir] = g_ldraw.x;
      lg_ray[kLDir + 1] = g_ldraw.y;
      lg_ray[kLDir + 2] = g_ldraw.z;
    }
#pragma unroll
    for (int j = 0; j < kLightGrads; ++j) {
      const float s = warp_sum(lg_ray[j]);
      if (lane == 0) lg[li * kLightGrads + j] += s;
    }
  }

  if (!live) return;

  // The second replay: the row is read again and the winner point and the
  // BRDF sample recomputed, through opaque() (see the note at the top).
  const float* trow2 = opaque(trow);
  const V3 d2 = opaque(d);
  const Hit h = winner_point(p, trow2, opaque(o), d2);
  normal = h.normal;
  const V3 wo2 = -d2;
  const V3 ke = ld3(trow2 + kKE);

  // Emission and soft-edge sky: rad += ((cov*beta)*ke)*es + ((1-cov)*beta)*sky.
  V3 g_ke;
  {
    const V3 g_y = c.rad * p.emission_scale;
    const V3 g_x = g_y * ke;
    g_ke = g_y * (h.cov * beta);
    g_beta = g_beta + g_x * h.cov;
    if (soft) {
      g_cov += dot(g_x, beta);
      const V3 g_a = c.rad * sky;
      g_beta = g_beta + g_a * (1.0f - h.cov);
      g_cov -= dot(g_a, beta);
    }
  }

  if (lo) {
    const Brdf b = sample_brdf(p, seed, normal, wo2, ld3(trow2 + kKD), ld3(trow2 + kKS),
                               trow2[kNS]);
    V3 g_ss = zero3(), g_tt = zero3();
    const V3 wi2 = b.wi;
    if (!b.pick_spec) {
      g_kd = g_kd + g_f * kInvPi;
      const float g_pd = g_pdf * kInvPi;  // pdf = dot(wi, n) / pi
      g_wi = g_wi + normal * g_pd;
      g_normal = g_normal + wi2 * g_pd;
      const V3 g_wraw = normalize_adj(b.wraw, g_wi);
      g_ss = g_ss + g_wraw * b.cp;
      g_tt = g_tt + g_wraw * b.sp;
      g_normal = g_normal + g_wraw * b.cos_t;
    } else {
      const V3 ks2 = ld3(trow2 + kKS);
      const float ns2 = trow2[kNS];
      // f = ks * scale, scale = ((d_ndf * G) * fr) / denom.
      g_ks = g_ks + g_f * b.scale;
      const float g_scale = dot(g_f, ks2);
      const float g_num = g_scale / b.denom;
      const float g_denom = -g_scale * b.num / (b.denom * b.denom);
      const float dG = b.d_ndf * b.G;
      const float g_dG = g_num * b.fr;
      const float g_fr = g_num * dG;
      float g_d_ndf = g_dG * b.G;
      const float g_G = g_dG * b.d_ndf;
      // pdf = pdf_h / max(4 wdw, 1e-8).
      const float g_pdf_h = g_pdf / b.pm;
      float g_wdw = dmax(4.0f * b.wdw, 1e-8f) * (-g_pdf * b.pdf_h / (b.pm * b.pm)) * 4.0f;
      // denom = (4 max(cos_i, 0)) max(cos_o, 0) + 1e-3.
      const float g_cos_i = dmax(b.cos_i, 0.0f) * (g_denom * b.mo * 4.0f);
      const float g_cos_o = dmax(b.cos_o, 0.0f) * (g_denom * (4.0f * b.mi));
      // Schlick: fr = 0.04 + 0.96 (x2 x2 x), x = max(1 - wdw, 0).
      const float g_q = 0.96f * g_fr;
      const float pq = b.x2 * b.x2;
      const float g_pq = g_q * b.xf;
      const float g_x2 = 2.0f * g_pq * b.x2;
      const float g_xf = g_q * pq + 2.0f * g_x2 * b.xf;
      g_wdw -= dmax(1.0f - b.wdw, 0.0f) * g_xf;
      // Smith G = g1(ndotv) g1(ndotl), g1(n) = n / (n (1 - k) + k).
      const float g_g1v = g_G * b.g1l, g_g1l = g_G * b.g1v;
      const float g_Dv = -g_g1v * b.ndotv / (b.Dv * b.Dv);
      const float g_Dl = -g_g1l * b.ndotl / (b.Dl * b.Dl);
      const float g_ndotv = g_g1v / b.Dv + g_Dv * (1.0f - b.k);
      const float g_ndotl = g_g1l / b.Dl + g_Dl * (1.0f - b.k);
      const float g_k = g_Dv * (1.0f - b.ndotv) + g_Dl * (1.0f - b.ndotl);
      const float g_dnv = dmax(b.dnv, 0.0f) * g_ndotv;
      const float g_dnl = dmax(b.dnl, 0.0f) * g_ndotl;
      g_normal = g_normal + wo2 * g_dnv + wi2 * g_dnl;
      g_wo = g_wo + normal * g_dnv;
      g_wi = g_wi + normal * g_dnl;
      float g_rough = g_k * b.rr * 0.25f;  // k = rr^2 / 8
      // cos_i = wi.n, cos_o = wo.n.
      g_wi = g_wi + normal * g_cos_i;
      g_normal = g_normal + wi2 * g_cos_i + wo2 * g_cos_o;
      g_wo = g_wo + normal * g_cos_o;
      // wdw = max(wo.wh, 0); wi = -wo + (2 wo.wh) wh.
      const float g_cww = dmax(b.c_wowh, 0.0f) * g_wdw + 2.0f * dot(g_wi, b.wh);
      const V3 g_wh = g_wi * (2.0f * b.c_wowh) + wo2 * g_cww;
      g_wo = g_wo - g_wi + b.wh * g_cww;
      // wh = normalize(ss cp + tt sp + n cos_h), cp = cos(phi) sin_h, ...
      const V3 g_whraw = normalize_adj(b.whraw, g_wh);
      g_ss = g_ss + g_whraw * b.cp;
      g_tt = g_tt + g_whraw * b.sp;
      g_normal = g_normal + g_whraw * b.cos_h;
      float g_cos_h = dot(g_whraw, normal);
      const float g_sin_h = dot(g_whraw, b.ss) * b.cphi + dot(g_whraw, b.tt) * b.sphi;
      float g_alpha = 0.0f;
      if (p.flags & F_GGX) {
        g_d_ndf += g_pdf_h * b.cos_h;  // pdf_h = d_ndf cos_h
        g_cos_h += g_pdf_h * b.d_ndf;
        // d_ndf = (a2 / pi) / max(dd^2, 1e-12), dd = cos_h2 (a2 - 1) + 1.
        float g_a2 = g_d_ndf * kInvPi / b.ddm;
        const float g_ddm = -g_d_ndf * (b.a2 * kInvPi) / (b.ddm * b.ddm);
        const float g_dd = dmax(b.dd * b.dd, 1e-12f) * g_ddm * 2.0f * b.dd;
        float g_cos_h2 = g_dd * (b.a2 - 1.0f);
        g_a2 += g_dd * b.cos_h2;
        g_cos_h2 += clip01_adj(b.cos_h2, g_cos_h / (2.0f * b.cos_h));
        g_cos_h2 -= dmax(1.0f - b.cos_h2, 0.0f) * sqrt0_adj(b.sh2, b.sin_h, g_sin_h);
        // cos_h2 = (1 - u2c) / (1 + (a2 - 1) u2c).
        g_a2 += -g_cos_h2 * (1.0f - b.u2c) / (b.den * b.den) * b.u2c;
        // a2 = max(a^2, 1e-12), a = rough^2.
        const float g_a = dmax(b.a_g * b.a_g, 1e-12f) * g_a2 * 2.0f * b.a_g;
        g_rough += g_a * 2.0f * b.rough;
      } else {
        // d_ndf = ((alpha + 2) / 2pi) cosn, pdf_h = ((alpha + 1) / 2pi) cosn,
        // cosn = exp(log_u2 alpha / a1), cos_h = exp(log_u2 / a1), a1 = alpha + 1.
        const float g_cosn = g_d_ndf * ((b.alpha + 2.0f) * kHalfInvPi) +
                             g_pdf_h * ((b.alpha + 1.0f) * kHalfInvPi);
        g_alpha += (g_d_ndf + g_pdf_h) * kHalfInvPi * b.cosn;
        const float g_ratio = g_cosn * b.cosn * b.log_u2;
        g_alpha += g_ratio / b.a1;
        float g_a1 = -g_ratio * b.alpha / (b.a1 * b.a1);
        g_cos_h -= 2.0f * b.cos_h * (dmax(1.0f - b.cos_h * b.cos_h, 0.0f) *
                                     sqrt0_adj(b.sh2, b.sin_h, g_sin_h));
        g_a1 -= g_cos_h * b.cos_h * b.log_u2 / (b.a1 * b.a1);
        g_alpha += g_a1;
      }
      // rough = sqrt(2 / (alpha + 2)).
      const float a2p = b.alpha + 2.0f;
      g_alpha += -(g_rough / (2.0f * b.rough)) * 2.0f / (a2p * a2p);
      g_ns += dmax(ns2, 0.0f) * g_alpha;
    }
    // ONB: tt = normalize(cross(axis, n)), ss = cross(n, tt).
    g_normal = g_normal + cross(b.tt, g_ss);
    g_tt = g_tt + cross(g_ss, normal);
    const V3 g_craw = normalize_adj(b.craw, g_tt);
    const V3 axis = fabsf(normal.x) > 1e-3f ? mk(0.0f, 1.0f, 0.0f) : mk(1.0f, 0.0f, 0.0f);
    g_normal = g_normal + cross(g_craw, axis);
    g_d = g_d - g_wo;  // wo = -d
  }

  // Soft coverage: cov = sigmoid(min(min(u, v), 1 - u - v) / sigma).
  const float u = h.u, v = h.v;
  float g_u = 0.0f, g_v = 0.0f;
  if (soft) {
    const float m1 = fminf(u, v);
    const float w2 = 1.0f - u - v;
    const float g_margin = g_cov * h.cov * (1.0f - h.cov) * p.inv_soft_sigma;
    const float g_m1 = dmin(m1, w2) * g_margin;
    const float g_w2 = dmin(w2, m1) * g_margin;
    g_u += dmin(u, v) * g_m1 - g_w2;
    g_v += dmin(v, u) * g_m1 - g_w2;
  }

  // Winner point: normal = normalize(u n1 + v n2 + w n0), w = 1 - u - v,
  // pos = o + d t, (t, u, v) recomputed from (v0, e1, e2).
  const V3 e1 = ld3(trow2 + kE1), e2 = ld3(trow2 + kE2);
  const V3 g_nraw = normalize_adj(h.nraw, g_normal);
  const V3 g_n0 = g_nraw * (1.0f - u - v);
  const V3 g_n1 = g_nraw * u;
  const V3 g_n2 = g_nraw * v;
  const float g_w = dot(g_nraw, ld3(trow2 + kN0));
  g_u += dot(g_nraw, ld3(trow2 + kN1)) - g_w;
  g_v += dot(g_nraw, ld3(trow2 + kN2)) - g_w;
  g_o = g_o + g_pos;
  g_d = g_d + g_pos * h.t;
  const float g_t = h.tvalid ? dot(g_pos, d2) : 0.0f;
  const float g_inv = g_u * dot(h.tvec, h.pvec) + g_v * dot(d2, h.qvec) + g_t * dot(e2, h.qvec);
  V3 g_tvec = h.pvec * (g_u * h.inv);
  V3 g_pvec = h.tvec * (g_u * h.inv);
  const V3 g_qvec = d2 * (g_v * h.inv) + e2 * (g_t * h.inv);
  g_d = g_d + h.qvec * (g_v * h.inv);
  V3 g_e2 = h.qvec * (g_t * h.inv);
  // qvec = cross(tvec, e1).
  g_tvec = g_tvec + cross(e1, g_qvec);
  V3 g_e1 = cross(g_qvec, h.tvec);
  // tvec = o - v0.
  g_o = g_o + g_tvec;
  const V3 g_v0 = -g_tvec;
  // inv = 1 / det, det = e1 . pvec, pvec = cross(d, e2).
  const float g_det = h.dvalid ? -g_inv * h.inv * h.inv : 0.0f;
  g_e1 = g_e1 + h.pvec * g_det;
  g_pvec = g_pvec + e1 * g_det;
  g_d = g_d + cross(e2, g_pvec);
  g_e2 = g_e2 + cross(g_pvec, d2);

  const V3 cols[9] = {g_v0, g_e1, g_e2, g_n0, g_n1, g_n2, g_kd, g_ks, g_ke};
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    row[3 * j] = cols[j].x;
    row[3 * j + 1] = cols[j].y;
    row[3 * j + 2] = cols[j].z;
  }
  row[kNS] = g_ns;
}

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

// Raygen of bounce0_fwd_kernel for one pixel, and its adjoint into the
// camera vector (position, right, up, front), added to cg.
struct Raygen {
  V3 o, d, draw;
  float x, y;
  uint32_t seed;
};

__device__ __forceinline__ Raygen raygen(const MegaParams& p, const float* cam, int pid) {
  Raygen r;
  r.seed = mix_u32((uint32_t)pid ^ p.rg_frame);
  const float px = (float)(pid % p.width);
  const float py = (float)(pid / p.width);
  const float jx = uniform_cm(r.seed, p.rg_jx);
  const float jy = uniform_cm(r.seed, p.rg_jy);
  r.x = (2.0f * (px + jx) * p.inv_w - 1.0f) * p.tan_half_fov * p.aspect;
  r.y = (1.0f - 2.0f * (py + jy) * p.inv_h) * p.tan_half_fov;
  r.draw = r.x * ld3(cam + kCamRight) + r.y * ld3(cam + kCamUp) + ld3(cam + kCamFront);
  r.d = normalize(r.draw);
  r.o = ld3(cam + kCamPos);
  return r;
}

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

// One round: the adjoint of the n <= kBlock rays at the head of the queue
// (thread t takes entry t), their table rows summed into the block's
// partial, their light and camera gradients into the warps' rows.
template <bool kFirst>
__device__ __forceinline__ void adjoint_round(const MegaParams& p, const BwdIO& io, Smem& s,
                                              float* acc, int head, int n) {
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
      if (in) r = raygen(p, io.cam, io.pixel_ids[j]);
      ray_adjoint(p, s.lights, io.tab, r.o, r.d, mk(1.0f, 1.0f, 1.0f), in, r.seed, win, occ, c,
                  g_o, g_d, g_beta, row, lg);
      if (in) raygen_adj(r, g_o, g_d, cg);
      w = in ? win : -1;
    } else {
      V3 o = zero3(), d = zero3(), beta = zero3();
      bool alive = false;
      uint32_t seed = 0;
      if (in) {
        o = ld_col(io.o, j, R);
        d = ld_col(io.d, j, R);
        beta = ld_col(io.beta, j, R);
        alive = io.alive[j] > 0.0f;
        seed = (uint32_t)io.seeds[j];
      }
      ray_adjoint(p, s.lights, io.tab, o, d, beta, alive, seed, win, occ, c, g_o, g_d, g_beta,
                  row, lg);
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
// kSmemTab puts the block's table partial in shared memory.
//
// Block b scans its tiles b, b + G, b + 2G, ... kTilesPerStep at a time.
// Rays without a winner (dead or missed) pass their cotangents through
// where the scan finds them, and the others join the queue in ray order.
// Whenever the queue holds
// kBlock rays a round differentiates them, and a last round takes the
// rest, so the warps that run the adjoint are full of live rays however
// few there are.
template <bool kFirst, bool kSmemTab>
__device__ __forceinline__ void bwd_body(const MegaParams& p, const BwdIO& io) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int R = p.num_rays, L = p.num_lights, G = gridDim.x;
  const int n_tab = p.num_tris * kTabCols;
  float* part = io.part + (size_t)blockIdx.x * part_cols(p, kFirst);
  float* acc = kSmemTab ? reinterpret_cast<float*>(smem_raw + sizeof(Smem)) : part;
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
            raygen_adj(raygen(p, io.cam, io.pixel_ids[i]), c.o, c.d, cg);
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
      adjoint_round<kFirst>(p, io, s, acc, head, n);
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
  bwd_body<true, kSmemTab>(p, io);
}

template <bool kSmemTab>
__global__ void __launch_bounds__(kBlock, 2)
bounce_bwd_kernel(MegaParams p, BwdIO io) {
  bwd_body<false, kSmemTab>(p, io);
}

// The second launch: column j of the G block partials, summed over 8
// slices of the rows (slice k takes rows k, k + 8, ... in order), then over
// the slices by a fixed pairwise tree; written to d_tab, d_lights or d_cam.
__global__ void __launch_bounds__(kBlock)
finish_kernel(const float* __restrict__ part, int G, int n, int n_tab, int n_light,
              float* d_tab, float* d_lights, float* d_cam) {
  __shared__ float red[kWarps][32];
  const int lane = threadIdx.x & 31, slice = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float v = 0.0f;
  if (col < n)
    for (int g = slice; g < G; g += kWarps) v += part[(size_t)g * n + col];
  red[slice][lane] = v;
  __syncthreads();
  for (int h = kWarps / 2; h > 0; h >>= 1) {
    if (slice < h) red[slice][lane] += red[slice + h][lane];
    __syncthreads();
  }
  if (slice == 0 && col < n) {
    v = red[0][lane];
    if (col < n_tab)
      d_tab[col] = v;
    else if (col < n_tab + n_light)
      d_lights[col - n_tab] = v;
    else
      d_cam[col - n_tab - n_light] = v;
  }
}

using BwdKernel = void(MegaParams, BwdIO);

template <BwdKernel* kKernel>
cudaError_t launch_bwd(const MegaParams& p, const BwdIO& io, int grid, bool smem_tab,
                       cudaStream_t st) {
  static bool ready = false;  // once per kernel: allow the table in shared memory
  if (!ready) {
    const int most = (int)(sizeof(Smem) + (size_t)kSmemRows * kTabCols * sizeof(float));
    const cudaError_t e =
        cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  const size_t bytes =
      sizeof(Smem) + (smem_tab ? (size_t)p.num_tris * kTabCols * sizeof(float) : 0);
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
  if (p->num_lights > kMaxLights || grid < 1 || (smem_tab && p->num_tris > kSmemRows))
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
// returns the first cudaError_t that is not cudaSuccess.
extern "C" int mrt_bounce0_bwd(const MegaParams* p, int grid, int smem_table,
                               const float* tab, const float* lights, const float* cam,
                               const int* pixel_ids, const int* winner, const int* occ,
                               const float* co, const float* cd, const float* cb, const float* cr,
                               float* part, float* d_tab, float* d_lights, float* d_cam,
                               void* stream) {
  if (p->num_rays <= 0) return 0;
  const int bad = check_args(p, grid, smem_table);
  if (bad) return bad;
  const cudaStream_t st = (cudaStream_t)stream;
  BwdIO io = {};
  io.tab = tab;
  io.lights = lights;
  io.cam = cam;
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
                              float* d_lights, void* stream) {
  if (p->num_rays <= 0) return 0;
  const int bad = check_args(p, grid, smem_table);
  if (bad) return bad;
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
  io.part = part;
  const cudaError_t e = smem_table
      ? launch_bwd<bounce_bwd_kernel<true>>(*p, io, grid, true, st)
      : launch_bwd<bounce_bwd_kernel<false>>(*p, io, grid, false, st);
  if (e != cudaSuccess) return (int)e;
  return (int)finish(*p, false, grid, part, d_tab, d_lights, nullptr, st);
}
