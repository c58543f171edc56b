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
// The TPU kernels run jax.vjp of a replay inside the kernel. Here the
// adjoint is written by hand, one thread per ray: ray_adjoint replays the
// forward bounce in the plain version's operation order (the same
// expressions as bounce_body in megakernel.cu, so every discrete decision
// -- pick_spec, the ONB axis, same_hemi, valid, ok, the light type and the
// spot branch -- replays bit for bit), keeps what the adjoint needs in
// registers, then runs the adjoint back through direct light, the BRDF
// lobe (Schlick / Smith / NDF, Blinn exp-log or GGX sqrt sampling), the
// ONB, the normalizes and the (t, u, v) recompute on the winner's table row
// (v0, e1, e2 in columns 0-8, as megakernel.py:_winner_point does). Rays
// that were not alive, and live rays whose path ends here, pass their
// (o, d, beta) cotangents through (megakernel.py:1001, 1015-1016). RNG
// draws carry no gradient. Where max / min / clamp tie, each side takes
// half the gradient, as jnp.maximum and jnp.clip do. sin(theta_h) =
// sqrt(max(1 - cos^2, 0)) takes zero gradient at 0, as ops/brdf.py's
// plain version does (there the true derivative is infinite and the JAX
// package's gradient is inf or NaN).
//
// Reductions. The table, light and camera gradients are sums over rays.
// On the TPU the grid ran in order and summed in place; here blocks run in
// parallel, and every sum is deterministic (repeated runs are bitwise
// equal, no atomics):
//   * lights and camera: each block sums its rays with warp shuffles and
//     a fixed-order pass over its warps into a per-block partial; a column
//     sum over the blocks, in block order, finishes it;
//   * table: each ray writes its 28 gradient columns to a [R, 32] scratch
//     row; reduce_rows_kernel gives one warp (a lane per column) a run of
//     rays, summed in ray order with a run-length accumulator (neighbouring
//     rays mostly share a winner) into a per-run [T_pad, 32] partial; a
//     column sum over the runs finishes it. The number of runs keeps the
//     partials under 16 MB for every T_pad up to the mega path's 2048
//     triangles, so one design serves every mega-eligible scene.
//
// What bounds it on this card: per-ray arithmetic and registers. A
// backward ray replays the forward shading (no intersection loop: the
// winner is given) and runs about twice as many flops again for the
// adjoint, with ~60 live floats; the forward kernels already use 63
// registers. Traffic is ~100 B of ray state and cotangents in, ~40 B of
// per-ray gradients and a 112 B table row out per live ray.
//
// What the design does about it: dead rays skip all of it; only the picked
// lobe is replayed and differentiated; lights sit in shared memory; no
// kernel allocates (the wrapper passes scratch and zeroed partials). Ray
// compaction, a register-lean adjoint and a faster table reduction are
// left for later.
//
// Built with the forward kernels' flags (no fast-math, -fmad=false).

#include "megakernel.cuh"

namespace {

constexpr int kRowGrads = 28;    // differentiable table columns, v0 .. ns
constexpr int kLightGrads = 10;  // light columns 0-9 (type gets zero)
constexpr int kCamGrads = 12;    // position, right, up, front
constexpr int kMaxLights = 30;
constexpr int kWarps = kBlock / 32;

struct Cot {
  V3 o, d, beta, rad;
};

__device__ __forceinline__ V3 zero3() { return mk(0.0f, 0.0f, 0.0f); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
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

// VJP of one bounce of ray i (the replay of bounce_body with the winner and
// the occlusion bits frozen). Every thread of the block calls it, rays out
// of range with alive = false: the light loop reduces across the warp.
// Returns d(o, d, beta); writes the winner row's 28 gradient columns to
// row_out when winner >= 0; adds each light's 10 gradient columns, summed
// over the warp, to s_lg[li * 10 + k] (lane 0 writes).
__device__ void ray_adjoint(const MegaParams& p, const float* s_lights,
                            const float* __restrict__ tab, V3 o, V3 d, V3 beta, bool alive,
                            uint32_t seed, int winner, int occ, const Cot& c, V3& g_o, V3& g_d,
                            V3& g_beta, float* row_out, float* s_lg) {
  const bool cull = p.flags & F_CULL;
  const bool soft = p.flags & F_SOFT;
  const bool ggx = p.flags & F_GGX;
  const bool dspec = p.flags & F_DSPEC;
  const bool shadow = p.flags & F_SHADOW;
  const V3 sky = mk(p.sky[0], p.sky[1], p.sky[2]);
  const bool live = alive && winner >= 0;

  // ---------------------------------------------------------------- replay
  V3 v0, e1, e2, n0, n1, n2, kd, ks, ke;
  float ns = 0.0f;
  V3 pvec, tvec, qvec, pos, nraw, normal;
  float det = 0.0f, inv = 0.0f, u = 0.0f, v = 0.0f, t = 0.0f, cov = 1.0f;
  bool dvalid = false, tvalid = false;
  // BRDF sample.
  V3 wo, craw, tt, ss, wraw, wi, f, whraw, wh;
  bool pick_spec = false, valid = false;
  float cphi = 0.0f, sphi = 0.0f, cp = 0.0f, sp = 0.0f, cos_t = 0.0f, pdf = 0.0f;
  float alpha = 0.0f, log_u2 = 0.0f, a1 = 0.0f, cos_h = 0.0f, sin_h = 0.0f, sh2 = 0.0f;
  float cosn = 0.0f, d_ndf = 0.0f, pdf_h = 0.0f, rough = 0.0f, a_g = 0.0f, a2 = 0.0f;
  float u2c = 0.0f, den = 0.0f, cos_h2 = 0.0f, dd = 0.0f, ddm = 0.0f;
  float c_wowh = 0.0f, cos_i = 0.0f, cos_o = 0.0f, wdw = 0.0f, pm = 0.0f, rr = 0.0f, k = 0.0f;
  float dnv = 0.0f, dnl = 0.0f, ndotv = 0.0f, ndotl = 0.0f, Dv = 0.0f, Dl = 0.0f;
  float g1v = 0.0f, g1l = 0.0f, G = 0.0f, xf = 0.0f, x2 = 0.0f, fr = 0.0f, mi = 0.0f;
  float mo = 0.0f, denom = 0.0f, num = 0.0f, scale = 0.0f;
  float cos_i2 = 0.0f, pdf_safe = 1.0f;
  V3 mul, beta_new;
  bool lo = false;
  float diff_w = 0.0f, spec_w = 0.0f;

  if (live) {
    const float* row = tab + (size_t)winner * kTabCols;
    v0 = ld3(row + kV0);
    e1 = ld3(row + kE1);
    e2 = ld3(row + kE2);
    n0 = ld3(row + kN0);
    n1 = ld3(row + kN1);
    n2 = ld3(row + kN2);
    kd = ld3(row + kKD);
    ks = ld3(row + kKS);
    ke = ld3(row + kKE);
    ns = row[kNS];

    // (t, u, v) on the winner (megakernel.py:_winner_point).
    pvec = cross(d, e2);
    det = dot(e1, pvec);
    dvalid = cull ? det > kDetEps : fabsf(det) > kDetEps;
    inv = dvalid ? 1.0f / det : 0.0f;
    tvec = o - v0;
    u = dot(tvec, pvec) * inv;
    qvec = cross(tvec, e1);
    v = dot(d, qvec) * inv;
    const float t_raw = dot(e2, qvec) * inv;
    tvalid = dvalid && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t_raw > 0.0f;
    t = tvalid ? t_raw : kBig;
    const float w = 1.0f - u - v;
    pos = o + d * t;
    nraw = u * n1 + v * n2 + w * n0;
    normal = normalize(nraw);
    if (soft) {
      const float margin = fminf(fminf(u, v), 1.0f - u - v);
      cov = 1.0f / (1.0f + expf(-(margin * p.inv_soft_sigma)));
    }

    wo = -d;
    pick_spec = uniform_cm(seed, p.cms[0]) > p.spec_threshold;
    const bool use_y = fabsf(normal.x) > 1e-3f;
    const V3 axis = use_y ? mk(0.0f, 1.0f, 0.0f) : mk(1.0f, 0.0f, 0.0f);
    craw = cross(axis, normal);
    tt = normalize(craw);
    ss = cross(normal, tt);
    if (!pick_spec) {
      const float du1 = uniform_cm(seed, p.cms[1]);
      const float du2 = uniform_cm(seed, p.cms[2]);
      const float phi = kTwoPi * du1;
      const float sin_t = sqrtf(du2);
      cos_t = sqrtf(fmaxf(1.0f - du2, 0.0f));
      cphi = cosf(phi);
      sphi = sinf(phi);
      cp = cphi * sin_t;
      sp = sphi * sin_t;
      wraw = ss * cp + tt * sp + normal * cos_t;
      wi = normalize(wraw);
      pdf = dot(wi, normal) * kInvPi;
      f = kd * kInvPi;
      valid = pdf > 0.0f;
    } else {
      const float su1 = uniform_cm(seed, p.cms[3]);
      const float su2 = uniform_cm(seed, p.cms[4]);
      const float phi = kTwoPi * su1;
      cphi = cosf(phi);
      sphi = sinf(phi);
      alpha = fmaxf(ns, 0.0f);
      if (ggx) {
        rough = sqrtf(2.0f / (alpha + 2.0f));
        a_g = rough * rough;
        a2 = fmaxf(a_g * a_g, 1e-12f);
        u2c = clampf(su2, 0.0f, 1.0f - 1e-7f);
        den = 1.0f + (a2 - 1.0f) * u2c;
        cos_h2 = (1.0f - u2c) / den;
        cos_h = sqrtf(clampf(cos_h2, 0.0f, 1.0f));
        sh2 = fmaxf(1.0f - cos_h2, 0.0f);
        sin_h = sqrtf(sh2);
        dd = cos_h2 * (a2 - 1.0f) + 1.0f;
        ddm = fmaxf(dd * dd, 1e-12f);
        d_ndf = a2 * kInvPi / ddm;
        pdf_h = d_ndf * cos_h;
      } else {
        log_u2 = logf(clampf(su2, 1e-12f, 1.0f));
        a1 = alpha + 1.0f;
        cos_h = expf(log_u2 / a1);
        sh2 = fmaxf(1.0f - cos_h * cos_h, 0.0f);
        sin_h = sqrtf(sh2);
        cosn = expf(log_u2 * (alpha / a1));
        d_ndf = (alpha + 2.0f) * kHalfInvPi * cosn;
        pdf_h = (alpha + 1.0f) * kHalfInvPi * cosn;
        rough = sqrtf(2.0f / (alpha + 2.0f));
      }
      cp = cphi * sin_h;
      sp = sphi * sin_h;
      whraw = ss * cp + tt * sp + normal * cos_h;
      wh = normalize(whraw);
      c_wowh = dot(wo, wh);
      wi = -wo + (2.0f * c_wowh) * wh;
      cos_i = dot(wi, normal);
      cos_o = dot(wo, normal);
      const bool same_hemi = cos_i * cos_o >= 1e-6f;
      wdw = fmaxf(c_wowh, 0.0f);
      pm = fmaxf(4.0f * wdw, 1e-8f);
      pdf = pdf_h / pm;
      rr = rough + 1.0f;
      k = (rr * rr) / 8.0f;
      dnv = dot(normal, wo);
      ndotv = fmaxf(dnv, 0.0f);
      dnl = dot(normal, wi);
      ndotl = fmaxf(dnl, 0.0f);
      Dv = ndotv * (1.0f - k) + k;
      Dl = ndotl * (1.0f - k) + k;
      g1v = ndotv / Dv;
      g1l = ndotl / Dl;
      G = g1v * g1l;
      xf = fmaxf(1.0f - wdw, 0.0f);
      x2 = xf * xf;
      fr = 0.04f + 0.96f * (x2 * x2 * xf);
      mi = fmaxf(cos_i, 0.0f);
      mo = fmaxf(cos_o, 0.0f);
      denom = 4.0f * mi * mo + 1e-3f;
      num = d_ndf * G * fr;
      scale = num / denom;
      valid = same_hemi && pdf > 0.0f && wdw > 0.0f;
      f = valid ? ks * scale : zero3();
    }
    cos_i2 = dot(wi, normal);
    pdf_safe = pdf > 0.0f ? pdf : 1.0f;
    mul = f * (cos_i2 / pdf_safe);
    lo = valid && pdf > 0.0f && isfinite(mul.x) && isfinite(mul.y) && isfinite(mul.z);
  }

  // Direct light weights (the forward's light loop, occlusion replayed).
  if (lo) {
    beta_new = beta * mul;
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
  V3 g_kd = zero3(), g_ks = zero3(), g_ke = zero3();
  float g_ns = 0.0f, g_cov = 0.0f, g_diff_w = 0.0f, g_spec_w = 0.0f;
  V3 g_f = zero3();
  float g_pdf = 0.0f;

  if (lo) {
    // o' = pos + wi * eps, d' = wi (kernel_bvh.cl:380).
    g_pos = c.o;
    g_wi = c.o * p.ray_eps + c.d;
    // radiance += (cov * direct) * beta_new.
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
    // beta_new = beta * mul, mul = f * (cos_i2 / pdf).
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

  // Lights, in a loop every thread runs: each light's gradient is summed
  // over the warp before lane 0 adds it to the block's shared row.
  const int lane = threadIdx.x & 31;
  for (int li = 0; li < p.num_lights; ++li) {
    float lg[kLightGrads];
#pragma unroll
    for (int j = 0; j < kLightGrads; ++j) lg[j] = 0.0f;
    const float* lrow = s_lights + kLightCols * li;
    const bool blocked = shadow && ((occ >> li) & 1);
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
      lg[kLInt] = g_ai * attn;
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
        lg[kLCut] = -g_swr / cc - dmax(1.0f - cos_cut, 1e-6f) * g_cc;
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
        lg[kLAtt] = g_fd * dist;
        g_to_l = mk(g_lu.x / dist, g_lu.y / dist, g_lu.z / dist);
        g_dist -= dot(g_lu, to_l) / (dist * dist);
        const float g_dq = dmax(dq, 1e-12f) * (g_dist / (2.0f * dist));
        g_to_l = g_to_l + to_l * (2.0f * g_dq);
        g_pos = g_pos - g_to_l;
      }
      lg[kLPos] = g_to_l.x;
      lg[kLPos + 1] = g_to_l.y;
      lg[kLPos + 2] = g_to_l.z;
      const V3 g_ldraw = normalize_adj(ldraw, g_ldir);
      lg[kLDir] = g_ldraw.x;
      lg[kLDir + 1] = g_ldraw.y;
      lg[kLDir + 2] = g_ldraw.z;
    }
#pragma unroll
    for (int j = 0; j < kLightGrads; ++j) {
      const float s = warp_sum(lg[j]);
      if (lane == 0) s_lg[li * kLightGrads + j] += s;
    }
  }

  if (!live) {
    if (winner >= 0 && row_out != nullptr)
      for (int j = 0; j < kRowGrads; ++j) row_out[j] = 0.0f;
    return;
  }

  // Emission and soft-edge sky: rad += ((cov*beta)*ke)*es + ((1-cov)*beta)*sky.
  {
    const V3 g_y = c.rad * p.emission_scale;
    const V3 g_x = g_y * ke;
    g_ke = g_ke + g_y * (cov * beta);
    g_beta = g_beta + g_x * cov;
    if (soft) {
      g_cov += dot(g_x, beta);
      const V3 g_a = c.rad * sky;
      g_beta = g_beta + g_a * (1.0f - cov);
      g_cov -= dot(g_a, beta);
    }
  }

  V3 g_ss = zero3(), g_tt = zero3();
  if (lo) {
    if (!pick_spec) {
      g_kd = g_kd + g_f * kInvPi;
      const float g_pd = g_pdf * kInvPi;  // pdf = dot(wi, n) / pi
      g_wi = g_wi + normal * g_pd;
      g_normal = g_normal + wi * g_pd;
      const V3 g_wraw = normalize_adj(wraw, g_wi);
      g_ss = g_ss + g_wraw * cp;
      g_tt = g_tt + g_wraw * sp;
      g_normal = g_normal + g_wraw * cos_t;
    } else {
      // f = ks * scale, scale = ((d_ndf * G) * fr) / denom.
      g_ks = g_ks + g_f * scale;
      const float g_scale = dot(g_f, ks);
      const float g_num = g_scale / denom;
      const float g_denom = -g_scale * num / (denom * denom);
      const float dG = d_ndf * G;
      const float g_dG = g_num * fr;
      const float g_fr = g_num * dG;
      float g_d_ndf = g_dG * G;
      const float g_G = g_dG * d_ndf;
      // pdf = pdf_h / max(4 wdw, 1e-8).
      const float g_pdf_h = g_pdf / pm;
      float g_wdw = dmax(4.0f * wdw, 1e-8f) * (-g_pdf * pdf_h / (pm * pm)) * 4.0f;
      // denom = (4 max(cos_i, 0)) max(cos_o, 0) + 1e-3.
      float g_cos_i = dmax(cos_i, 0.0f) * (g_denom * mo * 4.0f);
      float g_cos_o = dmax(cos_o, 0.0f) * (g_denom * (4.0f * mi));
      // Schlick: fr = 0.04 + 0.96 (x2 x2 x), x = max(1 - wdw, 0).
      const float g_q = 0.96f * g_fr;
      const float pq = x2 * x2;
      const float g_pq = g_q * xf;
      const float g_x2 = 2.0f * g_pq * x2;
      const float g_xf = g_q * pq + 2.0f * g_x2 * xf;
      g_wdw -= dmax(1.0f - wdw, 0.0f) * g_xf;
      // Smith G = g1(ndotv) g1(ndotl), g1(n) = n / (n (1 - k) + k).
      const float g_g1v = g_G * g1l, g_g1l = g_G * g1v;
      const float g_Dv = -g_g1v * ndotv / (Dv * Dv);
      const float g_Dl = -g_g1l * ndotl / (Dl * Dl);
      const float g_ndotv = g_g1v / Dv + g_Dv * (1.0f - k);
      const float g_ndotl = g_g1l / Dl + g_Dl * (1.0f - k);
      const float g_k = g_Dv * (1.0f - ndotv) + g_Dl * (1.0f - ndotl);
      const float g_dnv = dmax(dnv, 0.0f) * g_ndotv;
      const float g_dnl = dmax(dnl, 0.0f) * g_ndotl;
      g_normal = g_normal + wo * g_dnv + wi * g_dnl;
      g_wo = g_wo + normal * g_dnv;
      g_wi = g_wi + normal * g_dnl;
      float g_rough = g_k * rr * 0.25f;  // k = rr^2 / 8
      // cos_i = wi.n, cos_o = wo.n.
      g_wi = g_wi + normal * g_cos_i;
      g_normal = g_normal + wi * g_cos_i + wo * g_cos_o;
      g_wo = g_wo + normal * g_cos_o;
      // wdw = max(wo.wh, 0); wi = -wo + (2 wo.wh) wh.
      float g_cww = dmax(c_wowh, 0.0f) * g_wdw + 2.0f * dot(g_wi, wh);
      V3 g_wh = g_wi * (2.0f * c_wowh) + wo * g_cww;
      g_wo = g_wo - g_wi + wh * g_cww;
      // wh = normalize(ss cp + tt sp + n cos_h), cp = cos(phi) sin_h, ...
      const V3 g_whraw = normalize_adj(whraw, g_wh);
      g_ss = g_ss + g_whraw * cp;
      g_tt = g_tt + g_whraw * sp;
      g_normal = g_normal + g_whraw * cos_h;
      float g_cos_h = dot(g_whraw, normal);
      const float g_sin_h = dot(g_whraw, ss) * cphi + dot(g_whraw, tt) * sphi;
      float g_alpha = 0.0f;
      if (ggx) {
        g_d_ndf += g_pdf_h * cos_h;  // pdf_h = d_ndf cos_h
        g_cos_h += g_pdf_h * d_ndf;
        // d_ndf = (a2 / pi) / max(dd^2, 1e-12), dd = cos_h2 (a2 - 1) + 1.
        float g_a2 = g_d_ndf * kInvPi / ddm;
        const float g_ddm = -g_d_ndf * (a2 * kInvPi) / (ddm * ddm);
        const float g_dd = dmax(dd * dd, 1e-12f) * g_ddm * 2.0f * dd;
        float g_cos_h2 = g_dd * (a2 - 1.0f);
        g_a2 += g_dd * cos_h2;
        g_cos_h2 += clip01_adj(cos_h2, g_cos_h / (2.0f * cos_h));
        g_cos_h2 -= dmax(1.0f - cos_h2, 0.0f) * sqrt0_adj(sh2, sin_h, g_sin_h);
        // cos_h2 = (1 - u2c) / (1 + (a2 - 1) u2c).
        g_a2 += -g_cos_h2 * (1.0f - u2c) / (den * den) * u2c;
        // a2 = max(a^2, 1e-12), a = rough^2.
        const float g_a = dmax(a_g * a_g, 1e-12f) * g_a2 * 2.0f * a_g;
        g_rough += g_a * 2.0f * rough;
      } else {
        // d_ndf = ((alpha + 2) / 2pi) cosn, pdf_h = ((alpha + 1) / 2pi) cosn,
        // cosn = exp(log_u2 alpha / a1), cos_h = exp(log_u2 / a1), a1 = alpha + 1.
        const float g_cosn = g_d_ndf * ((alpha + 2.0f) * kHalfInvPi) +
                             g_pdf_h * ((alpha + 1.0f) * kHalfInvPi);
        g_alpha += (g_d_ndf + g_pdf_h) * kHalfInvPi * cosn;
        const float g_ratio = g_cosn * cosn * log_u2;
        g_alpha += g_ratio / a1;
        float g_a1 = -g_ratio * alpha / (a1 * a1);
        g_cos_h -= 2.0f * cos_h * (dmax(1.0f - cos_h * cos_h, 0.0f) *
                                   sqrt0_adj(sh2, sin_h, g_sin_h));
        g_a1 -= g_cos_h * cos_h * log_u2 / (a1 * a1);
        g_alpha += g_a1;
      }
      // rough = sqrt(2 / (alpha + 2)).
      const float a2p = alpha + 2.0f;
      g_alpha += -(g_rough / (2.0f * rough)) * 2.0f / (a2p * a2p);
      g_ns += dmax(ns, 0.0f) * g_alpha;
    }
    // ONB: tt = normalize(cross(axis, n)), ss = cross(n, tt).
    g_normal = g_normal + cross(tt, g_ss);
    g_tt = g_tt + cross(g_ss, normal);
    const V3 g_craw = normalize_adj(craw, g_tt);
    const V3 axis = fabsf(normal.x) > 1e-3f ? mk(0.0f, 1.0f, 0.0f) : mk(1.0f, 0.0f, 0.0f);
    g_normal = g_normal + cross(g_craw, axis);
    g_d = g_d - g_wo;  // wo = -d
  }

  // Soft coverage: cov = sigmoid(min(min(u, v), 1 - u - v) / sigma).
  float g_u = 0.0f, g_v = 0.0f;
  if (soft) {
    const float m1 = fminf(u, v);
    const float w2 = 1.0f - u - v;
    const float g_margin = g_cov * cov * (1.0f - cov) * p.inv_soft_sigma;
    const float g_m1 = dmin(m1, w2) * g_margin;
    const float g_w2 = dmin(w2, m1) * g_margin;
    g_u += dmin(u, v) * g_m1 - g_w2;
    g_v += dmin(v, u) * g_m1 - g_w2;
  }

  // Winner point: normal = normalize(u n1 + v n2 + w n0), w = 1 - u - v,
  // pos = o + d t, (t, u, v) recomputed from (v0, e1, e2).
  const V3 g_nraw = normalize_adj(nraw, g_normal);
  const V3 g_n0 = g_nraw * (1.0f - u - v);
  const V3 g_n1 = g_nraw * u;
  const V3 g_n2 = g_nraw * v;
  const float g_w = dot(g_nraw, n0);
  g_u += dot(g_nraw, n1) - g_w;
  g_v += dot(g_nraw, n2) - g_w;
  g_o = g_o + g_pos;
  g_d = g_d + g_pos * t;
  const float g_t = tvalid ? dot(g_pos, d) : 0.0f;
  const float g_inv = g_u * dot(tvec, pvec) + g_v * dot(d, qvec) + g_t * dot(e2, qvec);
  V3 g_tvec = pvec * (g_u * inv);
  V3 g_pvec = tvec * (g_u * inv);
  V3 g_qvec = d * (g_v * inv) + e2 * (g_t * inv);
  g_d = g_d + qvec * (g_v * inv);
  V3 g_e2 = qvec * (g_t * inv);
  // qvec = cross(tvec, e1).
  g_tvec = g_tvec + cross(e1, g_qvec);
  V3 g_e1 = cross(g_qvec, tvec);
  // tvec = o - v0.
  g_o = g_o + g_tvec;
  const V3 g_v0 = -g_tvec;
  // inv = 1 / det, det = e1 . pvec, pvec = cross(d, e2).
  const float g_det = dvalid ? -g_inv * inv * inv : 0.0f;
  g_e1 = g_e1 + pvec * g_det;
  g_pvec = g_pvec + e1 * g_det;
  g_d = g_d + cross(e2, g_pvec);
  g_e2 = g_e2 + cross(g_pvec, d);

  if (row_out != nullptr) {
    const V3 cols[9] = {g_v0, g_e1, g_e2, g_n0, g_n1, g_n2, g_kd, g_ks, g_ke};
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      row_out[3 * j] = cols[j].x;
      row_out[3 * j + 1] = cols[j].y;
      row_out[3 * j + 2] = cols[j].z;
    }
    row_out[kNS] = g_ns;
  }
}

__device__ __forceinline__ V3 ld_col(const float* a, int i, int R) {
  return mk(a[i], a[R + i], a[2 * R + i]);
}

__device__ __forceinline__ void st_col(float* a, int i, int R, V3 v) {
  a[i] = v.x;
  a[R + i] = v.y;
  a[2 * R + i] = v.z;
}

// Stage the lights and zero the per-warp light-gradient rows.
__device__ __forceinline__ void stage_bwd(const MegaParams& p, const float* __restrict__ lights,
                                          float* s_lights, float* s_lg) {
  for (int k = threadIdx.x; k < p.num_lights * kLightCols; k += blockDim.x) s_lights[k] = lights[k];
  for (int k = threadIdx.x; k < kWarps * kMaxLights * kLightGrads; k += blockDim.x) s_lg[k] = 0.0f;
  __syncthreads();
}

// The block's light gradients, summed over its warps in order, to its
// [L, 16] partial (columns 10-15 zero).
__device__ __forceinline__ void store_light_partial(const MegaParams& p, const float* s_lg,
                                                    float* light_part) {
  __syncthreads();
  float* out = light_part + (size_t)blockIdx.x * p.num_lights * kLightCols;
  for (int k = threadIdx.x; k < p.num_lights * kLightCols; k += blockDim.x) {
    const int li = k / kLightCols, j = k % kLightCols;
    float s = 0.0f;
    if (j < kLightGrads)
      for (int w = 0; w < kWarps; ++w) s += s_lg[w * kMaxLights * kLightGrads + li * kLightGrads + j];
    out[k] = s;
  }
}

// The ray's winner; -1 for rays out of range and for indices outside the
// table (p.num_tris holds T_pad), so no kernel reads or writes past it.
__device__ __forceinline__ int load_winner(const MegaParams& p, const int* winner, int i) {
  if (i >= p.num_rays) return -1;
  const int w = winner[i];
  return w < p.num_tris ? w : -1;
}

__device__ __forceinline__ Cot load_cot(const float* co, const float* cd, const float* cb,
                                        const float* cr, int i, int R) {
  return {ld_col(co, i, R), ld_col(cd, i, R), ld_col(cb, i, R), ld_col(cr, i, R)};
}

__global__ void __launch_bounds__(kBlock)
bounce0_bwd_kernel(MegaParams p, const float* __restrict__ tab, const float* __restrict__ lights,
                   const float* __restrict__ cam, const int* __restrict__ pixel_ids,
                   const int* __restrict__ winner, const int* __restrict__ occ,
                   const float* __restrict__ co, const float* __restrict__ cd,
                   const float* __restrict__ cb, const float* __restrict__ cr, float* rows,
                   float* light_part, float* cam_part) {
  __shared__ float s_lights[kMaxLights * kLightCols];
  __shared__ float s_lg[kWarps * kMaxLights * kLightGrads];
  __shared__ float s_cg[kWarps * kCamGrads];
  stage_bwd(p, lights, s_lights, s_lg);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int R = p.num_rays;
  const bool in = i < R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // Raygen replay (bounce0_fwd_kernel).
  V3 o = zero3(), d = mk(0.0f, 0.0f, 1.0f), draw = d;
  float x = 0.0f, y = 0.0f;
  uint32_t seed = 0;
  Cot c = {zero3(), zero3(), zero3(), zero3()};
  if (in) {
    const int pid = pixel_ids[i];
    seed = mix_u32((uint32_t)pid ^ p.rg_frame);
    const float px = (float)(pid % p.width);
    const float py = (float)(pid / p.width);
    const float jx = uniform_cm(seed, p.rg_jx);
    const float jy = uniform_cm(seed, p.rg_jy);
    x = (2.0f * (px + jx) * p.inv_w - 1.0f) * p.tan_half_fov * p.aspect;
    y = (1.0f - 2.0f * (py + jy) * p.inv_h) * p.tan_half_fov;
    draw = x * ld3(cam + kCamRight) + y * ld3(cam + kCamUp) + ld3(cam + kCamFront);
    d = normalize(draw);
    o = ld3(cam + kCamPos);
    c = load_cot(co, cd, cb, cr, i, R);
  }
  V3 g_o, g_d, g_beta;
  ray_adjoint(p, s_lights, tab, o, d, mk(1.0f, 1.0f, 1.0f), in, seed, load_winner(p, winner, i),
              in ? occ[i] : 0, c, g_o, g_d, g_beta, in ? rows + (size_t)i * kTabCols : nullptr,
              s_lg + warp * kMaxLights * kLightGrads);

  // Raygen adjoint into the camera vector (position, right, up, front).
  float cg[kCamGrads];
#pragma unroll
  for (int j = 0; j < kCamGrads; ++j) cg[j] = 0.0f;
  if (in) {
    const V3 g_draw = normalize_adj(draw, g_d);
    const V3 parts[4] = {g_o, g_draw * x, g_draw * y, g_draw};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      cg[3 * j] = parts[j].x;
      cg[3 * j + 1] = parts[j].y;
      cg[3 * j + 2] = parts[j].z;
    }
  }
#pragma unroll
  for (int j = 0; j < kCamGrads; ++j) {
    const float s = warp_sum(cg[j]);
    if (lane == 0) s_cg[warp * kCamGrads + j] = s;
  }
  store_light_partial(p, s_lg, light_part);  // begins with __syncthreads
  if (threadIdx.x < 16) {
    float s = 0.0f;
    if (threadIdx.x < kCamGrads)
      for (int w = 0; w < kWarps; ++w) s += s_cg[w * kCamGrads + threadIdx.x];
    cam_part[(size_t)blockIdx.x * 16 + threadIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kBlock)
bounce_bwd_kernel(MegaParams p, const float* __restrict__ tab, const float* __restrict__ lights,
                  const float* __restrict__ o_in, const float* __restrict__ d_in,
                  const float* __restrict__ beta_in, const float* __restrict__ alive_in,
                  const int* __restrict__ seeds, const int* __restrict__ winner,
                  const int* __restrict__ occ, const float* __restrict__ co,
                  const float* __restrict__ cd, const float* __restrict__ cb,
                  const float* __restrict__ cr, float* rows, float* light_part, float* d_o,
                  float* d_d, float* d_beta) {
  __shared__ float s_lights[kMaxLights * kLightCols];
  __shared__ float s_lg[kWarps * kMaxLights * kLightGrads];
  stage_bwd(p, lights, s_lights, s_lg);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int R = p.num_rays;
  const bool in = i < R;
  const int warp = threadIdx.x >> 5;
  V3 o = zero3(), d = zero3(), beta = zero3();
  Cot c = {zero3(), zero3(), zero3(), zero3()};
  bool alive = false;
  if (in) {
    o = ld_col(o_in, i, R);
    d = ld_col(d_in, i, R);
    beta = ld_col(beta_in, i, R);
    alive = alive_in[i] > 0.0f;
    c = load_cot(co, cd, cb, cr, i, R);
  }
  V3 g_o, g_d, g_beta;
  ray_adjoint(p, s_lights, tab, o, d, beta, alive, in ? (uint32_t)seeds[i] : 0u,
              load_winner(p, winner, i), in ? occ[i] : 0, c, g_o, g_d, g_beta,
              in ? rows + (size_t)i * kTabCols : nullptr, s_lg + warp * kMaxLights * kLightGrads);
  if (in) {
    st_col(d_o, i, R, g_o);
    st_col(d_d, i, R, g_d);
    st_col(d_beta, i, R, g_beta);
  }
  store_light_partial(p, s_lg, light_part);
}

// Table gradient, stage 1: run g (rays [g * chunk, (g + 1) * chunk)) sums
// its rays' rows by winner, in ray order, into part[g] ([T_pad, 32], zeroed
// by the wrapper). One warp per run, lane = table column.
__global__ void __launch_bounds__(32)
reduce_rows_kernel(int R, int T_pad, int chunk, const int* __restrict__ winner,
                   const float* __restrict__ rows, float* part) {
  const int g = blockIdx.x, col = threadIdx.x;
  const int r0 = g * chunk, r1 = min(R, r0 + chunk);
  float* pg = part + (size_t)g * T_pad * kTabCols;
  int cur = -1;
  float acc = 0.0f;
  for (int r = r0; r < r1; ++r) {
    const int w = winner[r];
    if (w < 0 || w >= T_pad) continue;
    const float val = col < kRowGrads ? rows[(size_t)r * kTabCols + col] : 0.0f;
    if (w != cur) {
      if (cur >= 0) pg[cur * kTabCols + col] += acc;
      cur = w;
      acc = val;
    } else {
      acc += val;
    }
  }
  if (cur >= 0) pg[cur * kTabCols + col] += acc;
}

// out[j] = sum over g of part[g, j], in g order.
__global__ void colsum_kernel(const float* __restrict__ part, int G, int n, float* out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float s = 0.0f;
  for (int g = 0; g < G; ++g) s += part[(size_t)g * n + j];
  out[j] = s;
}

cudaError_t colsum(const float* part, int G, int n, float* out, cudaStream_t st) {
  if (n <= 0) return cudaSuccess;
  colsum_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0, st>>>(part, G, n, out);
  return cudaGetLastError();
}

// The table reduction after the per-ray kernel: runs, then their sum.
cudaError_t reduce_table(const MegaParams& p, int runs, const int* winner, const float* rows,
                         float* row_part, float* d_tab, cudaStream_t st) {
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int T_pad = p.num_tris;
  const int chunk = (p.num_rays + runs - 1) / runs;
  reduce_rows_kernel<<<runs, 32, 0, st>>>(p.num_rays, T_pad, chunk, winner, rows, row_part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return colsum(row_part, runs, T_pad * kTabCols, d_tab, st);
}

}  // namespace

// C entry points (ops/cuda/build.py). p->num_tris holds T_pad, the table's
// row count; `runs` is the number of table-reduction runs, whose
// [runs, T_pad, 32] partials the wrapper zeroes. Each launches its kernels
// on the given stream, does not synchronise, and returns the first
// launch's cudaError_t that is not cudaSuccess.
extern "C" int mrt_bounce0_bwd(const MegaParams* p, int runs, const float* tab,
                               const float* lights, const float* cam, const int* pixel_ids,
                               const int* winner, const int* occ, const float* co,
                               const float* cd, const float* cb, const float* cr, float* rows,
                               float* row_part, float* light_part, float* cam_part,
                               float* d_tab, float* d_lights, float* d_cam, void* stream) {
  if (p->num_rays <= 0) return 0;
  if (p->num_lights > kMaxLights) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (p->num_rays + kBlock - 1) / kBlock;
  bounce0_bwd_kernel<<<blocks, kBlock, 0, st>>>(*p, tab, lights, cam, pixel_ids, winner, occ,
                                                co, cd, cb, cr, rows, light_part, cam_part);
  cudaError_t e = reduce_table(*p, runs, winner, rows, row_part, d_tab, st);
  if (e != cudaSuccess) return (int)e;
  e = colsum(light_part, blocks, p->num_lights * kLightCols, d_lights, st);
  if (e != cudaSuccess) return (int)e;
  return (int)colsum(cam_part, blocks, 16, d_cam, st);
}

extern "C" int mrt_bounce_bwd(const MegaParams* p, int runs, const float* tab, const float* lights,
                              const float* o, const float* d, const float* beta,
                              const float* alive, const int* seeds, const int* winner,
                              const int* occ, const float* co, const float* cd, const float* cb,
                              const float* cr, float* rows, float* row_part, float* light_part,
                              float* d_o, float* d_d, float* d_beta, float* d_tab,
                              float* d_lights, void* stream) {
  if (p->num_rays <= 0) return 0;
  if (p->num_lights > kMaxLights) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (p->num_rays + kBlock - 1) / kBlock;
  bounce_bwd_kernel<<<blocks, kBlock, 0, st>>>(*p, tab, lights, o, d, beta, alive, seeds, winner,
                                               occ, co, cd, cb, cr, rows, light_part, d_o, d_d,
                                               d_beta);
  cudaError_t e = reduce_table(*p, runs, winner, rows, row_part, d_tab, st);
  if (e != cudaSuccess) return (int)e;
  return (int)colsum(light_part, blocks, p->num_lights * kLightCols, d_lights, st);
}
