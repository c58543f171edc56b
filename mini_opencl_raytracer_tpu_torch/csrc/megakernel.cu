// Fused path-tracing bounce kernels for Hopper (sm_90a).
//
// Two entry points share one __device__ bounce body:
//
//   bounce0_fwd_kernel  replaces mini_opencl_raytracer_tpu/ops/pallas/
//                       megakernel.py:_bounce0_fwd_kernel (K1): jittered
//                       pinhole raygen and per-pixel seeds in-kernel, then
//                       the first bounce.
//   bounce_fwd_kernel   replaces megakernel.py:_bounce_fwd_kernel (K2): one
//                       bounce from the carried ray state (bounces >= 1),
//                       forward only (no residual rows).
//
// A bounce is: closest hit over all triangles (Moller-Trumbore, exact f32
// divide, strict '<' so the lowest index wins a tie, |det| > 1e-10 or
// det > 1e-10 under backface culling, t < t_max); the winner's shading row;
// sky / emission / soft-edge coverage; Blinn or GGX lobe sampling with the
// counter-based lowbias32 RNG; direct light over all lights with optional
// any-hit shadow rays; throughput update and the next ray. The arithmetic
// follows the plain PyTorch version (ops/integrator.shade_hit and its
// callees) operation for operation; seeds and uniforms are bit-identical.
//
// What bounds it on this card: per-ray compute and warp divergence, not
// bytes. For Cornell (36 triangles) a ray reads and writes ~60 bytes of
// state per bounce but runs 36 (plus 36 per light with shadow rays)
// Moller-Trumbore tests and a few dozen transcendentals, and rays of one
// warp take different lobes, miss, or die at different bounces.
//
// What the design does about it:
//   * one thread per ray, a 1-D grid, the ragged tail masked;
//   * the triangles (v0, e1, e2: 36 bytes each) and the lights are staged
//     in shared memory once per block, so the intersection loops read
//     broadcast shared memory, never device memory;
//   * the winner's attributes come from one 128-byte row of a
//     triangle-major [T_pad, 32] table (replacing the TPU's one-hot
//     matmul gather);
//   * rays that are dead skip the bounce, only the picked lobe is
//     evaluated, and shadow rays exit at the first occluder;
//   * the RNG counters are premixed on the host and passed as scalars.
// Tensor cores, TMA, ray sorting and persistent blocks are left for later.
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

namespace {

// One closest-hit test of record ``tr``: true where its t is below t_best,
// with (t, u, v). NaN-safe comparisons reject what the plain version's
// (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0) rejects.
__device__ __forceinline__ bool mt_closest(const float* tr, V3 o, V3 d, bool cull,
                                           float t_best, float& t_out, float& u_out,
                                           float& v_out) {
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
  return true;
}

// Closest hit over the staged triangles. Returns the winner index (-1 on a
// miss) and its (t, u, v); a strict '<' in index order, so the lowest
// index wins a tie.
__device__ __forceinline__ int closest_hit(const float* s_tris, int T, V3 o, V3 d,
                                           float t_max, bool cull, float& t_out,
                                           float& u_out, float& v_out) {
  int best = -1;
  float t_best = t_max;
  for (int k = 0; k < T; ++k)
    if (mt_closest(s_tris + kTriCols * k, o, d, cull, t_best, t_best, u_out, v_out)) best = k;
  t_out = t_best;
  return best;
}

// One any-hit test: true where record ``tr`` lies at 0 < t < t_lim.
// Division-free on sign-adjusted determinants (megakernel.py:595-601).
__device__ __forceinline__ bool mt_occludes(const float* tr, V3 o, V3 d, float t_lim,
                                            bool cull) {
  const V3 v0 = ld3(tr), e1 = ld3(tr + 3), e2 = ld3(tr + 6);
  const V3 pvec = cross(d, e2);
  float det = dot(e1, pvec);
  const V3 tvec = o - v0;
  float ud = dot(tvec, pvec);
  const V3 qvec = cross(tvec, e1);
  float vd = dot(d, qvec);
  float td = dot(e2, qvec);
  if (!cull && det < 0.0f) {
    det = -det;
    ud = -ud;
    vd = -vd;
    td = -td;
  }
  return det > kDetEps && ud >= 0.0f && vd >= 0.0f && ud + vd <= det && td > 0.0f &&
         td < t_lim * det;
}

// Any-hit: true where some triangle lies at 0 < t < t_lim, exiting at the
// first occluder; ``tests`` gains the records tested.
__device__ __forceinline__ bool any_hit(const float* s_tris, int T, V3 o, V3 d,
                                        float t_lim, bool cull, int& tests) {
  for (int k = 0; k < T; ++k)
    if (mt_occludes(s_tris + kTriCols * k, o, d, t_lim, cull)) {
      tests += k + 1;
      return true;
    }
  tests += T;
  return false;
}

// closest_hit behind the warp's cull (bundle.cuh): called by all 32 lanes;
// a lane with ``live`` false tests nothing and misses. ``tests`` counts
// this lane's exact tests.
__device__ __forceinline__ int closest_bundle(const float* s_tris, int T, V3 o, V3 d,
                                              float t_max, bool cull, bool live, float& t_out,
                                              float& u_out, float& v_out, int& tests) {
  const Bundle b = make_bundle(live, o, d, t_max);
  if (b.dense) {  // the whole warp runs closest_hit's loop
    t_out = t_max;
    if (!live) return -1;
    tests += T;
    return closest_hit(s_tris, T, o, d, t_max, cull, t_out, u_out, v_out);
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
      if (mt_closest(s_tris + kTriCols * k, o, d, cull, t_best, t_best, u_out, v_out)) best = k;
    }
  }
  t_out = t_best;
  return best;
}

// any_hit behind the warp's cull, as closest_bundle; a warp stops when each
// of its rays has found an occluder.
__device__ __forceinline__ bool any_bundle(const float* s_tris, int T, V3 o, V3 d,
                                           float t_lim, bool cull, bool live, int& tests) {
  const Bundle b = make_bundle(live, o, d, t_lim);
  bool hit = false;
  if (b.dense) return live && any_hit(s_tris, T, o, d, t_lim, cull, tests);
  for (int r = 0; r < T; r += 32) {
    if (__all_sync(kFull, hit || !live)) break;
    unsigned mask = round_mask(b, s_tris, r, T);
    while (mask) {
      const int k = r + __ffs(mask) - 1;
      mask &= mask - 1;
      if (hit || !live) continue;
      ++tests;
      hit = mt_occludes(s_tris + kTriCols * k, o, d, t_lim, cull);
    }
  }
  return hit;
}

// One bounce of ray i (ops/integrator.shade_hit after the closest hit).
struct RayOut {
  V3 o, d, beta, rad;
  bool alive;
  int winner, occ;
};

// kCull (K1): the closest hit and the shadow rays run behind the warp's
// cull, so every lane of the warp stays in the body while a warp reduction may
// follow: a lane whose path ends goes on with its result set and its
// later work discarded. Without it (K2), the loops are dense and a lane
// returns as soon as its path ends.
template <bool kCull>
__device__ RayOut bounce_body(const MegaParams& p, const float* s_tris,
                              const float* s_lights, const float* __restrict__ tab,
                              V3 o, V3 d, V3 beta, bool alive, uint32_t seed, int& tests) {
  RayOut r;
  r.o = o;
  r.d = d;
  r.beta = beta;
  r.rad = mk(0.0f, 0.0f, 0.0f);
  r.alive = false;
  r.winner = -1;
  r.occ = 0;
  if (!kCull && !alive) return r;

  const bool cull = p.flags & F_CULL;
  const bool shadow = p.flags & F_SHADOW;
  // With the cull and shadow rays, every lane stays for the shadow rays' bundles.
  const bool stay = kCull && shadow;
  float t, u = 0.0f, v = 0.0f;
  const int best =
      kCull ? closest_bundle(s_tris, p.num_tris, o, d, p.t_max, cull, alive, t, u, v, tests)
            : closest_hit(s_tris, p.num_tris, o, d, p.t_max, cull, t, u, v);
  const V3 sky = mk(p.sky[0], p.sky[1], p.sky[2]);
  const bool hit = best >= 0;
  if (!hit && alive) r.rad = beta * sky;  // miss -> constant-grey sky (kernel_bvh.cl:358-362)
  if (stay ? !__any_sync(kFull, hit) : !hit) return r;
  r.winner = best;

  const float* row = tab + (size_t)(hit ? best : 0) * kTabCols;
  const V3 n0 = ld3(row + kN0), n1 = ld3(row + kN1), n2 = ld3(row + kN2);
  const V3 kd = ld3(row + kKD), ks = ld3(row + kKS), ke = ld3(row + kKE);
  const float ns = row[kNS];

  const float w = 1.0f - u - v;
  const V3 pos = o + d * t;
  const V3 normal = normalize(u * n1 + v * n2 + w * n0);

  float cov = 1.0f;
  V3 rad = mk(0.0f, 0.0f, 0.0f);
  if (p.flags & F_SOFT) {
    const float margin = fminf(fminf(u, v), 1.0f - u - v);
    cov = 1.0f / (1.0f + expf(-(margin * p.inv_soft_sigma)));
    rad = (1.0f - cov) * beta * sky;
  }
  rad = rad + cov * beta * ke * p.emission_scale;  // kernel_bvh.cl:365

  // BRDF sampling: only the lobe the roulette picks is evaluated.
  const V3 wo = -d;
  const bool pick_spec = uniform_cm(seed, p.cms[0]) > p.spec_threshold;
  const bool use_y = fabsf(normal.x) > 1e-3f;
  const V3 axis = use_y ? mk(0.0f, 1.0f, 0.0f) : mk(1.0f, 0.0f, 0.0f);
  const V3 tt = normalize(cross(axis, normal));
  const V3 ss = cross(normal, tt);

  V3 wi, f;
  float pdf;
  bool valid;
  if (!pick_spec) {  // Lambert lobe (kernel_bvh.cl:264-269)
    const float du1 = uniform_cm(seed, p.cms[1]);
    const float du2 = uniform_cm(seed, p.cms[2]);
    const float phi = kTwoPi * du1;
    const float sin_t = sqrtf(du2);
    const float cos_t = sqrtf(fmaxf(1.0f - du2, 0.0f));
    wi = normalize(ss * (cosf(phi) * sin_t) + tt * (sinf(phi) * sin_t) + normal * cos_t);
    pdf = dot(wi, normal) * kInvPi;
    f = kd * kInvPi;
    valid = pdf > 0.0f;
  } else {
    const float su1 = uniform_cm(seed, p.cms[3]);
    const float su2 = uniform_cm(seed, p.cms[4]);
    const float phi = kTwoPi * su1;
    float cos_h, sin_h, d_ndf, pdf_h, rough;
    if (p.flags & F_GGX) {  // DistributionGGX (kernel_bvh.cl:221-225)
      rough = sqrtf(2.0f / (fmaxf(ns, 0.0f) + 2.0f));
      const float a = rough * rough;
      const float a2 = fmaxf(a * a, 1e-12f);
      const float u2c = clampf(su2, 0.0f, 1.0f - 1e-7f);
      const float cos_h2 = (1.0f - u2c) / (1.0f + (a2 - 1.0f) * u2c);
      cos_h = sqrtf(clampf(cos_h2, 0.0f, 1.0f));
      sin_h = sqrtf(fmaxf(1.0f - cos_h2, 0.0f));
      const float dd = cos_h2 * (a2 - 1.0f) + 1.0f;
      d_ndf = a2 * kInvPi / fmaxf(dd * dd, 1e-12f);
      pdf_h = d_ndf * cos_h;
    } else {  // Blinn half-vector lobe, exponent Ns (ops/brdf.sample_specular)
      const float alpha = fmaxf(ns, 0.0f);
      const float log_u2 = logf(clampf(su2, 1e-12f, 1.0f));
      cos_h = expf(log_u2 / (alpha + 1.0f));
      sin_h = sqrtf(fmaxf(1.0f - cos_h * cos_h, 0.0f));
      const float cosn = expf(log_u2 * (alpha / (alpha + 1.0f)));
      d_ndf = (alpha + 2.0f) * kHalfInvPi * cosn;
      pdf_h = (alpha + 1.0f) * kHalfInvPi * cosn;
      rough = sqrtf(2.0f / (alpha + 2.0f));
    }
    const V3 wh =
        normalize(ss * (cosf(phi) * sin_h) + tt * (sinf(phi) * sin_h) + normal * cos_h);
    wi = -wo + (2.0f * dot(wo, wh)) * wh;  // reflect (kernel_bvh.cl:74-77)
    const float cos_i = dot(wi, normal);
    const float cos_o = dot(wo, normal);
    const bool same_hemi = cos_i * cos_o >= 1e-6f;
    const float wo_dot_wh = fmaxf(dot(wo, wh), 0.0f);
    pdf = pdf_h / fmaxf(4.0f * wo_dot_wh, 1e-8f);
    // Smith G with the reference's k mapping (kernel_bvh.cl:241-257).
    const float r1 = rough + 1.0f;
    const float k = (r1 * r1) / 8.0f;
    const float ndotv = fmaxf(dot(normal, wo), 0.0f);
    const float ndotl = fmaxf(dot(normal, wi), 0.0f);
    const float g = (ndotv / (ndotv * (1.0f - k) + k)) * (ndotl / (ndotl * (1.0f - k) + k));
    const float x = fmaxf(1.0f - wo_dot_wh, 0.0f);
    const float x2 = x * x;
    const float fr = 0.04f + 0.96f * (x2 * x2 * x);  // Schlick, F0 = 0.04
    const float denom = 4.0f * fmaxf(cos_i, 0.0f) * fmaxf(cos_o, 0.0f) + 1e-3f;
    valid = same_hemi && pdf > 0.0f && wo_dot_wh > 0.0f;
    f = valid ? ks * (d_ndf * g * fr / denom) : mk(0.0f, 0.0f, 0.0f);
  }

  const float cos_i = dot(wi, normal);
  const float pdf_safe = pdf > 0.0f ? pdf : 1.0f;
  const V3 mul = f * (cos_i / pdf_safe);
  const bool ok = valid && pdf > 0.0f && isfinite(mul.x) && isfinite(mul.y) &&
                  isfinite(mul.z);
  const bool go = hit && ok;
  if (!go) {  // the path ends here (kernel_bvh.cl:371-372)
    if (hit) r.rad = rad;
    if (!stay) return r;
  }
  const V3 beta_new = beta * mul;

  // Direct analytic light (lightPixel, kernel_bvh.cl:304-347), weighted by
  // Kd and the updated beta.
  const bool dspec = p.flags & F_DSPEC;
  float diff_w = 0.0f, spec_w = 0.0f;
  int occ = 0;
  for (int li = 0; li < p.num_lights; ++li) {
    const float* lrow = s_lights + kLightCols * li;
    const V3 ldir = normalize(ld3(lrow + kLDir));
    const int ltype = (int)rintf(lrow[kLType]);
    const float intensity = lrow[kLInt];
    const float falloff = lrow[kLAtt];
    const float cos_cut = lrow[kLCut];
    const V3 to_l = ld3(lrow + kLPos) - pos;
    const float dist = sqrtf(fmaxf(dot(to_l, to_l), 1e-12f));
    const bool is_dir = ltype <= 0;
    const V3 l_unit =
        is_dir ? -ldir : mk(to_l.x / dist, to_l.y / dist, to_l.z / dist);
    const float ndotl = fmaxf(dot(normal, l_unit), 0.0f);
    float attn = is_dir ? 1.0f : 1.0f / fmaxf(falloff * dist * dist, 1e-6f);
    if (ltype >= 2) {  // spot cone
      const float cos_angle = dot(-l_unit, ldir);
      attn = attn * clampf((cos_angle - cos_cut) / fmaxf(1.0f - cos_cut, 1e-6f), 0.0f, 1.0f);
    }
    bool blocked = false;
    if (shadow) {
      const V3 so = pos + l_unit * p.ray_eps;
      const float t_lim = is_dir ? kBig : dist - 2.0f * p.ray_eps;
      blocked = kCull ? any_bundle(s_tris, p.num_tris, so, l_unit, t_lim, cull, go, tests)
                      : any_hit(s_tris, p.num_tris, so, l_unit, t_lim, cull, tests);
      if (blocked) occ |= 1 << li;
    }
    if (!blocked) diff_w += attn * intensity * ndotl;
    if (dspec) {
      const V3 h = normalize(l_unit + wo);
      const float ndoth = fmaxf(dot(normal, h), 0.0f);
      float spec = powf(fmaxf(ndoth, 1e-6f), fmaxf(ns, 1.0f));
      spec = ndotl > 0.0f ? spec : 0.0f;
      if (!blocked) spec_w += attn * intensity * spec;
    }
  }
  V3 direct = diff_w * kd;
  if (dspec) direct = direct + spec_w * ks;
  rad = rad + cov * direct * beta_new;
  if (!go) return r;

  r.o = pos + wi * p.ray_eps;  // respawn (kernel_bvh.cl:380)
  r.d = wi;
  r.beta = beta_new;
  r.rad = rad;
  r.alive = true;
  r.occ = occ;
  return r;
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
bounce0_fwd_kernel(MegaParams p, const float* __restrict__ tab, const float* __restrict__ tris,
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

  // Raygen (ops/camera.rays_from_basis + ops/rng.pixel_seeds).
  const int pid = in ? pixel_ids[i] : 0;
  const uint32_t seed = mix_u32((uint32_t)pid ^ p.rg_frame);
  const float px = (float)(pid % p.width);
  const float py = (float)(pid / p.width);
  const float jx = uniform_cm(seed, p.rg_jx);
  const float jy = uniform_cm(seed, p.rg_jy);
  const float x = (2.0f * (px + jx) * p.inv_w - 1.0f) * p.tan_half_fov * p.aspect;
  const float y = (1.0f - 2.0f * (py + jy) * p.inv_h) * p.tan_half_fov;
  const V3 d = normalize(x * ld3(cam + kCamRight) + y * ld3(cam + kCamUp) +
                         ld3(cam + kCamFront));
  const V3 o = ld3(cam + kCamPos);

  int tests = 0;
  const RayOut r =
      bounce_body<true>(p, s_tris, s_lights, tab, o, d, mk(1.0f, 1.0f, 1.0f), in, seed, tests);
  if (!in) return;
  store(r, i, p.num_rays, o_out, d_out, beta_out, alive_out, rad_out, idx_out, occ_out);
  seeds_out[i] = (int)seed;
  if (stats) stats[i] = tests;
}

__global__ void __launch_bounds__(kBlock)
bounce_fwd_kernel(MegaParams p, const float* __restrict__ tab, const float* __restrict__ tris,
                  const float* __restrict__ lights, const float* __restrict__ o_in,
                  const float* __restrict__ d_in, const float* __restrict__ beta_in,
                  const float* __restrict__ alive_in, const int* __restrict__ seeds,
                  float* o_out, float* d_out, float* beta_out, float* alive_out,
                  float* rad_out, int* idx_out, int* occ_out) {
  extern __shared__ float smem[];
  float* s_tris = smem;
  float* s_lights = smem + p.num_tris * kTriCols;
  stage(p, tris, lights, s_tris, s_lights);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.num_rays) return;
  const int R = p.num_rays;
  const V3 o = mk(o_in[i], o_in[R + i], o_in[2 * R + i]);
  const V3 d = mk(d_in[i], d_in[R + i], d_in[2 * R + i]);
  const V3 beta = mk(beta_in[i], beta_in[R + i], beta_in[2 * R + i]);
  int tests = 0;
  const RayOut r = bounce_body<false>(p, s_tris, s_lights, tab, o, d, beta, alive_in[i] > 0.0f,
                                      (uint32_t)seeds[i], tests);
  store(r, i, R, o_out, d_out, beta_out, alive_out, rad_out, idx_out, occ_out);
}

size_t smem_bytes(const MegaParams& p) {
  return sizeof(float) * ((size_t)p.num_tris * kTriCols + (size_t)p.num_lights * kLightCols);
}

// Above 48 KB of dynamic shared memory a kernel must opt in.
template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// C entry points (bound with ctypes by ops/cuda/build.py). Each launches
// on the given stream, does not synchronise, and returns the launch's
// cudaError_t.
extern "C" int mrt_bounce0_fwd(const MegaParams* p, const float* tab, const float* tris,
                               const float* lights, const float* cam, const int* pixel_ids,
                               float* o, float* d, float* beta, float* alive, float* rad,
                               int* idx, int* occ, int* seeds, int* stats, void* stream) {
  if (p->num_rays <= 0) return 0;
  const size_t smem = smem_bytes(*p);
  cudaError_t e = prepare(bounce0_fwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (p->num_rays + kBlock - 1) / kBlock;
  bounce0_fwd_kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      *p, tab, tris, lights, cam, pixel_ids, o, d, beta, alive, rad, idx, occ, seeds, stats);
  return (int)cudaGetLastError();
}

extern "C" int mrt_bounce_fwd(const MegaParams* p, const float* tab, const float* tris,
                              const float* lights, const float* o_in, const float* d_in,
                              const float* beta_in, const float* alive_in, const int* seeds,
                              float* o, float* d, float* beta, float* alive, float* rad,
                              int* idx, int* occ, void* stream) {
  if (p->num_rays <= 0) return 0;
  const size_t smem = smem_bytes(*p);
  cudaError_t e = prepare(bounce_fwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (p->num_rays + kBlock - 1) / kBlock;
  bounce_fwd_kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      *p, tab, tris, lights, o_in, d_in, beta_in, alive_in, seeds, o, d, beta, alive, rad, idx,
      occ);
  return (int)cudaGetLastError();
}

extern "C" const char* mrt_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }
