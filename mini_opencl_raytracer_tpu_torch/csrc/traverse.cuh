// Device helpers of the wavefront intersection kernels (panel.cu,
// clustered.cu): the Moller-Trumbore test on (v0, e1, e2) records and the
// AABB slab test, each in its plain version's operation order.
#pragma once

#include "megakernel.cuh"

namespace {

// Moller-Trumbore on a [9] record (v0, e1 = v1 - v0, e2 = v2 - v0), in
// ops/intersect.ray_triangle_edges's order: det = e1 . (d x e2), a
// correctly rounded 1 / det, then u, v and t as products with it. True
// where |det| > 1e-10 (det > 1e-10 under culling), u >= 0, v >= 0,
// u + v <= 1 and t > 0; NaN-safe comparisons reject what the plain
// version's masks reject. Zero records (padding) have det == 0.
__device__ __forceinline__ bool mt_hit(V3 o, V3 d, const float* tr, bool cull, float& t) {
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
  t = dot(e2, qvec) * inv;
  return t > 0.0f;
}

// Slab test of a 16-byte-aligned AABB row (lo.xyz, hi.xyz, two unused
// floats), read as a float4 and a float2, against a ray given by its
// origin and inverse direction (ops/cuda/clustered._slab). Returns the
// clamped entry distance max(tmin, 0) and sets ``hit`` where
// min(tmax, t_far) >= entry: inclusive, so a box at exactly the best t is
// still visited.
__device__ __forceinline__ float slab(const float* row, V3 o, V3 inv, float t_far, bool& hit) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(row));
  const float2 b = __ldg(reinterpret_cast<const float2*>(row + 4));
  const float tx1 = (a.x - o.x) * inv.x, tx2 = (a.w - o.x) * inv.x;
  const float ty1 = (a.y - o.y) * inv.y, ty2 = (b.x - o.y) * inv.y;
  const float tz1 = (a.z - o.z) * inv.z, tz2 = (b.y - o.z) * inv.z;
  const float tmin = fmaxf(fmaxf(fminf(tx1, tx2), fminf(ty1, ty2)), fminf(tz1, tz2));
  const float tmax = fminf(fminf(fmaxf(tx1, tx2), fmaxf(ty1, ty2)), fmaxf(tz1, tz2));
  const float entry = fmaxf(tmin, 0.0f);
  hit = fminf(tmax, t_far) >= entry;
  return entry;
}

// Above 48 KB of dynamic shared memory a kernel must opt in.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
