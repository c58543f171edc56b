// The shading of one bounce after the closest hit, shared by the mega
// path's forward kernels (megakernel.cu: K1 bounce0_fwd_kernel and K2
// bounce_fwd_kernel) and the wavefront's fused shading (shade.cu): the
// winner's attributes, sky / emission / soft-edge coverage, the lobe the
// roulette picks, direct light over all lights with optional any-hit
// shadow rays, the throughput update and the next ray. The arithmetic
// follows ops/integrator.shade_hit operation for operation.
//
// ``shade`` reads the winner's row through a layout given at compile time:
//   MegaRow   the mega path's [T_pad, 32] table (ops/cuda/megakernel.py
//             _V0.._NS: v0, e1, e2, n0, n1, n2, Kd, Ks, Ke, Ns);
//   TableRow  the wavefront's [T, 34] ShadingTable (ops/shading.py: v0,
//             v1, v2, n0, n1, n2, uv0, uv1, uv2, Kd, Ks, Ke, Ns).
// ``kCarry`` (the wavefront) adds each of the bounce's radiance terms to
// the carried radiance ``rad_in`` as shade_hit does, one float add a term
// in its order (the sky of a miss or of the soft edge, the emission, the
// direct light), and casts no shadow rays; without it (K1, K2) the
// radiance out is the bounce's own, its terms summed from zero.
#pragma once

#include "bundle.cuh"
#include "megakernel.cuh"

namespace {

struct MegaRow {
  static constexpr int kCols = kTabCols;
  static constexpr int kN0 = ::kN0, kN1 = ::kN1, kN2 = ::kN2;
  static constexpr int kKD = ::kKD, kKS = ::kKS, kKE = ::kKE, kNS = ::kNS;
};

// ops/shading.py ShadingTable (tests/test_torch_shade_fused.py holds the two
// equal).
struct TableRow {
  static constexpr int kCols = 34;
  static constexpr int kV0 = 0, kV1 = 3, kV2 = 6;
  static constexpr int kN0 = 9, kN1 = 12, kN2 = 15;
  static constexpr int kKD = 24, kKS = 27, kKE = 30, kNS = 33;
};

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

// What a ray that is not alive, or misses, passes on: o, d, beta
// unchanged, no radiance, winner -1, no occlusion bits.
__device__ __forceinline__ RayOut pass_through(V3 o, V3 d, V3 beta) {
  RayOut r;
  r.o = o;
  r.d = d;
  r.beta = beta;
  r.rad = mk(0.0f, 0.0f, 0.0f);
  r.alive = false;
  r.winner = -1;
  r.occ = 0;
  return r;
}

// The bounce after the closest hit: winner ``best`` (-1 on a miss) at (t,
// u, v), 1 / det ``inv``.
//
// kCull (K1): the closest hit and the shadow rays run behind the warp's
// cull, so every lane of the warp stays in the body while a warp reduction may
// follow: a lane whose path ends goes on with its result set and its
// later work discarded. Without it (K2), the loops are dense and a lane
// returns as soon as its path ends.
//
// kResid (K2 with F_RESID) also stores the known-value rows that K4 reads
// (ops/known.py, rows_of's layout), each where this body computes its
// value, so nothing is evaluated twice and each row holds the bits K4
// would otherwise recompute: 1 / det, the coverage, the pick, the picked
// lobe's draw terms (diffuse cos phi sin t, sin phi sin t, cos t; Blinn log
// u2, cos_h, sin_h, cos phi, sin phi, cos^alpha, roughness; GGX roughness,
// clamped u2, cos_h, sin_h, cos phi, sin phi), and for a path that goes on
// each light's distance and, with direct specular, its Blinn-Phong power
// and the log of its base (K4 reads a light's rows only on such paths).
// The inverse lengths and the other lobe's rows stay unwritten (K4's
// normalizes keep their sqrt, megakernel_bwd.cu). ``rs`` points at row 0
// of the ray's column, rows ``stride`` apart; null on a miss.
//
// The winner's row is ``tab + best * Row::kCols``. kCarry: the radiance
// out is ``rad_in`` plus this bounce's terms, added one at a time (the
// file's note), and F_SHADOW is not read.
template <bool kCull, bool kResid, class Row = MegaRow, bool kCarry = false>
__device__ __forceinline__ RayOut shade(const MegaParams& p, const float* s_tris,
                                        const float* s_lights, const float* __restrict__ tab,
                                        V3 o, V3 d, V3 beta, bool alive, uint32_t seed,
                                        int& tests, int best, float t, float u, float v,
                                        float inv, float* rs, int stride, V3 rad_in = {}) {
  RayOut r = pass_through(o, d, beta);
  if constexpr (kCarry) r.rad = rad_in;
  const bool cull = p.flags & F_CULL;
  const bool shadow = !kCarry && (p.flags & F_SHADOW);
  // With the cull and shadow rays, every lane stays for the shadow rays' bundles.
  const bool stay = kCull && shadow;
  const V3 sky = mk(p.sky[0], p.sky[1], p.sky[2]);
  const bool hit = best >= 0;
  // miss -> constant-grey sky (kernel_bvh.cl:358-362)
  if (!hit && alive) r.rad = kCarry ? rad_in + beta * sky : beta * sky;
  if (stay ? !__any_sync(kFull, hit) : !hit) return r;
  r.winner = best;
  const size_t S = stride;
  const Rows rl = rows_of(p.flags, p.num_lights);
  if constexpr (kResid) rs[kInvDet * S] = inv;

  const float* row = tab + (size_t)(hit ? best : 0) * Row::kCols;
  const V3 n0 = ld3(row + Row::kN0), n1 = ld3(row + Row::kN1), n2 = ld3(row + Row::kN2);
  const V3 kd = ld3(row + Row::kKD), ks = ld3(row + Row::kKS), ke = ld3(row + Row::kKE);
  const float ns = row[Row::kNS];

  const float w = 1.0f - u - v;
  const V3 pos = o + d * t;
  const V3 nraw = u * n1 + v * n2 + w * n0;
  const V3 normal = normalize(nraw);

  float cov = 1.0f;
  V3 rad = kCarry ? rad_in : mk(0.0f, 0.0f, 0.0f);
  if (p.flags & F_SOFT) {
    const float margin = fminf(fminf(u, v), 1.0f - u - v);
    cov = 1.0f / (1.0f + expf(-(margin * p.inv_soft_sigma)));
    if constexpr (kResid) rs[rl.cov * S] = cov;
    rad = kCarry ? rad + (1.0f - cov) * beta * sky : (1.0f - cov) * beta * sky;
  }
  rad = rad + cov * beta * ke * p.emission_scale;  // kernel_bvh.cl:365

  // BRDF sampling: only the lobe the roulette picks is evaluated.
  const V3 wo = -d;
  const bool pick_spec = uniform_cm(seed, p.cms[0]) > p.spec_threshold;
  if constexpr (kResid) rs[rl.pick * S] = pick_spec ? 1.0f : 0.0f;
  const bool use_y = fabsf(normal.x) > 1e-3f;
  const V3 axis = use_y ? mk(0.0f, 1.0f, 0.0f) : mk(1.0f, 0.0f, 0.0f);
  const V3 craw = cross(axis, normal);
  const V3 tt = normalize(craw);
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
    const float cp = cosf(phi) * sin_t, sp = sinf(phi) * sin_t;
    if constexpr (kResid) {
      rs[rl.d_cp * S] = cp;
      rs[rl.d_sp * S] = sp;
      rs[rl.d_ct * S] = cos_t;
    }
    wi = normalize(ss * cp + tt * sp + normal * cos_t);
    pdf = dot(wi, normal) * kInvPi;
    f = kd * kInvPi;
    valid = pdf > 0.0f;
  } else {
    const float su1 = uniform_cm(seed, p.cms[3]);
    const float su2 = uniform_cm(seed, p.cms[4]);
    const float phi = kTwoPi * su1;
    const float cphi = cosf(phi), sphi = sinf(phi);
    float* sr = kResid ? rs + rl.spec * S : nullptr;
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
      if constexpr (kResid) {
        sr[kGRough * S] = rough;
        sr[kGU2c * S] = u2c;
        sr[kGCosH * S] = cos_h;
        sr[kGSinH * S] = sin_h;
        sr[kGCphi * S] = cphi;
        sr[kGSphi * S] = sphi;
      }
    } else {  // Blinn half-vector lobe, exponent Ns (ops/brdf.sample_specular)
      const float alpha = fmaxf(ns, 0.0f);
      const float log_u2 = logf(clampf(su2, 1e-12f, 1.0f));
      cos_h = expf(log_u2 / (alpha + 1.0f));
      sin_h = sqrtf(fmaxf(1.0f - cos_h * cos_h, 0.0f));
      const float cosn = expf(log_u2 * (alpha / (alpha + 1.0f)));
      d_ndf = (alpha + 2.0f) * kHalfInvPi * cosn;
      pdf_h = (alpha + 1.0f) * kHalfInvPi * cosn;
      rough = sqrtf(2.0f / (alpha + 2.0f));
      if constexpr (kResid) {
        sr[kBLogU2 * S] = log_u2;
        sr[kBCosH * S] = cos_h;
        sr[kBSinH * S] = sin_h;
        sr[kBCphi * S] = cphi;
        sr[kBSphi * S] = sphi;
        sr[kBCosn * S] = cosn;
        sr[kBRough * S] = rough;
      }
    }
    const V3 wh = normalize(ss * (cphi * sin_h) + tt * (sphi * sin_h) + normal * cos_h);
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
    float* lr = kResid ? rs + (rl.light + li * rl.per_light) * S : nullptr;
    const V3 ldir = normalize(ld3(lrow + kLDir));
    const int ltype = (int)rintf(lrow[kLType]);
    const float intensity = lrow[kLInt];
    const float falloff = lrow[kLAtt];
    const float cos_cut = lrow[kLCut];
    const V3 to_l = ld3(lrow + kLPos) - pos;
    const float dist = sqrtf(fmaxf(dot(to_l, to_l), 1e-12f));
    if constexpr (kResid) lr[kLDist * S] = dist;
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
      const float xb = fmaxf(ndoth, 1e-6f);
      float spec = powf(xb, fmaxf(ns, 1.0f));
      if constexpr (kResid) {
        lr[kLPow * S] = spec;
        lr[kLLog * S] = logf(fmaxf(xb, 1e-20f));
      }
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

}  // namespace
