// Per-warp ray-bundle cull for the dense intersection loops of the panel
// kernel (panel.cu, K5) and the first-bounce kernel (megakernel.cu, K1).
//
// Those loops run the exact Moller-Trumbore (M-T) test of every ray
// against every record, and nearly all of those tests fail: on the
// Cornell box at 1080p a warp's 32 primary rays meet ~1 of its 36
// triangles. So each warp first tests the records against its rays as a
// whole, conservatively, and runs the exact loop only over the records
// that test keeps, in ascending index order. The exact arithmetic does not
// change, and neither does the tie rule (strict '<' over ascending
// indices), so the results are the dense loop's bit for bit, as long as
// the cull never drops a record that the exact test accepts.
//
// The bundle: the warp reduces its live rays (REDUX min / max) to the box of
// their origins [olo, ohi], the box of their directions [dlo, dhi] and
// the largest of their limits thi (min / max are exact, so the order of
// the reduction does not matter). Lanes without a ray take part with an
// empty contribution; every lane reaches every reduction and ballot. A warp
// goes dense (the plain loop over every record) when a live ray has a
// non-finite origin or direction, or when its direction box straddles 0
// on two or more axes: incoherent rays, where the cull keeps nearly
// everything and costs more than it saves.
//
// The test (cull_keep), per record with corners v0, c1 = v0 + e1,
// c2 = v0 + e2 and box [blo, bhi]: does some ray of the bundle, at some
// 0 <= t <= thi, pass within a margin m of the box? Per axis a, with
// o_a in [olo, ohi] and d_a in [dlo, dhi] (dlo > 0; dhi < 0 mirrored),
// o_a + t d_a can reach [blo - m, bhi + m] only for
//   (blo - m - ohi) / dhi <= t <= (bhi + m - olo) / dlo,
// an axis whose direction interval holds 0 is unbounded, and the t ranges
// of the three axes and [0, thi (1 + 2^-16)] must meet (the division-free
// any-hit test accepts t up to thi (1 + 2^-23)). The bounds are computed in
// round-to-nearest float32, as products with the reciprocals 1 / dlo and
// 1 / dhi that the warp takes once, and then made outward: a factor
// 1 -/+ 2^-16 and 1e-30, against the three roundings (2^-24 relative each)
// of a reciprocal, a subtraction and a product. So the model of the cull (ops/cuda/bundle_cull.py)
// repeats every decision bitwise with plain float32 tensor operations.
// NaN never drops a record: the drop test is made of comparisons that are
// false on NaN, and a NaN in a min / max comes only from non-finite
// inputs, which make the warp dense (rays) or never pass M-T (records).
//
// Why the margin covers M-T. M-T is Cramer's rule on
// [-d | e1 | e2] (t, u, v) = o - v0: with exact numerators N and
// determinant det, and computed N' and det', the computed solution
// x' = N' / det' leaves the exact residual
//   [-d | e1 | e2] x' - (o - v0) = ([-d | e1 | e2] (N' - N) - (det' - det) (o - v0)) / det'.
// Each numerator and det is a triple product, computed with an error of at
// most ~30 eps times the product of its three factors' largest components,
// so the residual is at most ~4 * 30 eps * T * D * E1 * E2 / |det'|, where
// T bounds |o - v0| (the distance of the origin box from the record's box),
// D = max |d|, E1 = max |e1|, E2 = max |e2|. An accepted hit has computed
// u, v >= 0 and u + v <= 1, so the point P = v0 + u e1 + v e2 lies in the
// record's box (up to a few ulps), and the ray's point o + t' d at the
// accepted 0 < t' < limit <= thi lies within that residual of P. The test
// widens the box by
//   m = 512 eps * T * D * E1 * E2 / det_lo + 64 eps * S,
// with det_lo a lower bound of |det'| over the bundle: the interval of
// (e1 x e2) . d over the direction box, less 128 eps * D * E1 * E2 for the
// rounding of det and of that interval, and never below M-T's own 1e-10.
// The second term covers the rounding of the corners, of o - v0 and of the
// final products u, v, t (S = the largest |coordinate| of both boxes).
// At grazing incidence or on slivers det is small and m grows as
// 1 / |cos|: the record is kept, as it must be, since M-T's acceptance
// band grows the same way. Padding rows (zero records) have det = 0:
// det_lo floors at 1e-10, the box is a point at the origin, and a padding
// row that survives is rejected by the exact test.
#pragma once

#include "megakernel.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1.1920929e-7f;          // 2^-23
constexpr float kGraze = 512.0f * kEps;
constexpr float kDetErr = 128.0f * kEps;
constexpr float kAbsM = 64.0f * kEps;
constexpr float kOutLo = 1.0f - 1.52587890625e-5f;   // 1 - 2^-16
constexpr float kOutHi = 1.0f + 1.52587890625e-5f;
constexpr float kOutAbs = 1e-30f;
constexpr float kInf = __builtin_huge_valf();

struct Bundle {
  V3 olo, ohi, dlo, dhi, ilo, ihi;   // ilo = 1 / dlo, ihi = 1 / dhi
  float thi, D, SO;
  bool dense, empty;
};

// Warp min / max of a float in one integer reduction (REDUX): the bits
// are mapped to an unsigned key in the floats' order (-0 below +0, no NaN
// reaches here), reduced, and mapped back.
__device__ __forceinline__ unsigned f2key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key2f(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}
__device__ __forceinline__ float wmin(float x) {
  return key2f(__reduce_min_sync(kFull, f2key(x)));
}
__device__ __forceinline__ float wmax(float x) {
  return key2f(__reduce_max_sync(kFull, f2key(x)));
}
__device__ __forceinline__ bool fin3(V3 a) {
  return isfinite(a.x) && isfinite(a.y) && isfinite(a.z);
}
__device__ __forceinline__ float amax3(V3 a) { return fmaxf(fmaxf(a.x, a.y), a.z); }
__device__ __forceinline__ V3 vabs(V3 a) { return mk(fabsf(a.x), fabsf(a.y), fabsf(a.z)); }
__device__ __forceinline__ V3 vmin(V3 a, V3 b) {
  return mk(fminf(a.x, b.x), fminf(a.y, b.y), fminf(a.z, b.z));
}
__device__ __forceinline__ V3 vmax(V3 a, V3 b) {
  return mk(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z));
}

// Whether the warp is dense (a live ray not finite, or directions that
// straddle 0 on two or more axes) or empty (no live ray), by votes: the
// direction box's dlo_a > 0 holds where every lane that takes ``part``
// has d_a > 0 (and where none does: the empty box), dhi_a < 0 likewise.
__device__ __forceinline__ void bundle_kind(bool live, bool part, V3 d, bool& dense,
                                            bool& empty) {
  const int straddle =
      (!__all_sync(kFull, !part || d.x > 0.0f) && !__all_sync(kFull, !part || d.x < 0.0f)) +
      (!__all_sync(kFull, !part || d.y > 0.0f) && !__all_sync(kFull, !part || d.y < 0.0f)) +
      (!__all_sync(kFull, !part || d.z > 0.0f) && !__all_sync(kFull, !part || d.z < 0.0f));
  dense = __any_sync(kFull, live && !part) || straddle >= 2;
  empty = !__any_sync(kFull, live);
}
__device__ __forceinline__ bool takes_part(bool live, V3 o, V3 d) {
  return live && fin3(o) && fin3(d);
}

// The warp's bundle; called by all 32 lanes. ``live``: this lane has a ray
// (o, d) below ``limit``. Its kind comes first: a dense or empty warp
// needs nothing else.
__device__ __forceinline__ Bundle make_bundle(bool live, V3 o, V3 d, float limit) {
  const bool part = takes_part(live, o, d);
  Bundle b;
  bundle_kind(live, part, d, b.dense, b.empty);
  if (b.dense || b.empty) return b;
  b.dlo = mk(wmin(part ? d.x : kInf), wmin(part ? d.y : kInf), wmin(part ? d.z : kInf));
  b.dhi = mk(wmax(part ? d.x : -kInf), wmax(part ? d.y : -kInf), wmax(part ? d.z : -kInf));
  b.olo = mk(wmin(part ? o.x : kInf), wmin(part ? o.y : kInf), wmin(part ? o.z : kInf));
  b.ohi = mk(wmax(part ? o.x : -kInf), wmax(part ? o.y : -kInf), wmax(part ? o.z : -kInf));
  b.thi = wmax(part && !isnan(limit) ? limit : -kInf);
  b.D = amax3(vmax(vabs(b.dlo), vabs(b.dhi)));
  b.SO = amax3(vmax(vabs(b.olo), vabs(b.ohi)));
  b.ilo = mk(1.0f / b.dlo.x, 1.0f / b.dlo.y, 1.0f / b.dlo.z);
  b.ihi = mk(1.0f / b.dhi.x, 1.0f / b.dhi.y, 1.0f / b.dhi.z);
  return b;
}

// Entry / exit of one axis (see above); unbounded where [dlo, dhi] holds 0.
__device__ __forceinline__ void slab_axis(float lo, float hi, float olo, float ohi, float dlo,
                                          float dhi, float ilo, float ihi, float& t_in,
                                          float& t_out) {
  if (dlo > 0.0f) {
    t_in = (lo - ohi) * ihi;
    t_out = (hi - olo) * ilo;
  } else if (dhi < 0.0f) {
    t_in = (hi - olo) * ilo;
    t_out = (lo - ohi) * ihi;
  } else {
    t_in = -kInf;
    t_out = kInf;
  }
}

// The conservative test of one [9] record (v0, e1, e2) against the bundle:
// false only where no ray of the bundle can pass M-T on it below its limit.
// Operation order as ops/cuda/bundle_cull.keep.
__device__ __forceinline__ bool cull_keep(const Bundle& b, const float* rec) {
  const V3 v0 = ld3(rec), e1 = ld3(rec + 3), e2 = ld3(rec + 6);
  const V3 c1 = v0 + e1, c2 = v0 + e2;
  const V3 blo = vmin(vmin(v0, c1), c2), bhi = vmax(vmax(v0, c1), c2);
  const V3 n = cross(e1, e2);
  const float E1 = amax3(vabs(e1)), E2 = amax3(vabs(e2));
  const V3 p = n * b.dlo, q = n * b.dhi;
  const V3 lo = vmin(p, q), hi = vmax(p, q);
  const float sl = (lo.x + lo.y) + lo.z;
  const float sh = (hi.x + hi.y) + hi.z;
  const float g = sl > 0.0f ? sl : (sh < 0.0f ? -sh : 0.0f);
  const float e12d = (E1 * E2) * b.D;
  const float det_lo = fmaxf(g - kDetErr * e12d, kDetEps);
  const float T = amax3(vmax(b.ohi - blo, bhi - b.olo));
  const float S = fmaxf(b.SO, amax3(vmax(vabs(blo), vabs(bhi))));
  const float m = ((kGraze * T) * e12d) / det_lo + kAbsM * S;
  float ex, xx, ey, xy, ez, xz;
  slab_axis(blo.x - m, bhi.x + m, b.olo.x, b.ohi.x, b.dlo.x, b.dhi.x, b.ilo.x, b.ihi.x, ex, xx);
  slab_axis(blo.y - m, bhi.y + m, b.olo.y, b.ohi.y, b.dlo.y, b.dhi.y, b.ilo.y, b.ihi.y, ey, xy);
  slab_axis(blo.z - m, bhi.z + m, b.olo.z, b.ohi.z, b.dlo.z, b.dhi.z, b.ilo.z, b.ihi.z, ez, xz);
  float t_in = fmaxf(fmaxf(ex, ey), ez);
  float t_out = fminf(fminf(xx, xy), xz);
  t_in = (t_in >= 0.0f ? t_in * kOutLo : t_in * kOutHi) - kOutAbs;
  t_out = (t_out >= 0.0f ? t_out * kOutHi : t_out * kOutLo) + kOutAbs;
  return !(t_out < 0.0f || t_in > b.thi * kOutHi || t_out < t_in);
}

// The warp's mask of the records [base, base + n) of round ``base`` (at
// most 32) that cull_keep keeps (record base + lane on each lane), none
// for an empty warp. Dense warps do not come here: they run the dense
// loop.
__device__ __forceinline__ unsigned round_mask(const Bundle& b, const float* recs, int base,
                                               int n) {
  if (b.empty) return 0u;
  const int left = n - base;
  const int lane = threadIdx.x & 31;
  const bool k = lane < left && cull_keep(b, recs + kTriCols * (base + lane));
  return __ballot_sync(kFull, k);
}

}  // namespace
