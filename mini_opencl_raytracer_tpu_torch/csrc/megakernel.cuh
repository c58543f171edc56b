// Device helpers shared by the forward (megakernel.cu) and backward
// (megakernel_bwd.cu) bounce kernels: the launch parameters, the float3
// arithmetic, the lowbias32 RNG and the column layouts of the tables.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Must match ops/cuda/megakernel.py:_Params field for field. The frame's
// premix is not here: K1 and K3 read it from a device word (the JAX
// kernels' rgcms operand), so a captured launch reads each replay's frame.
struct MegaParams {
  int num_rays, num_tris, num_lights, flags;
  int width, height;
  float t_max, ray_eps, emission_scale, spec_threshold, inv_soft_sigma;
  float sky[3];
  float tan_half_fov, inv_w, inv_h, aspect;
  uint32_t cms[5];
  uint32_t rg_jx, rg_jy;
};

namespace {

// F_RESID: K2 writes the known-value residual rows, K4 reads them
// (cfg.bwd_residuals; K1 and K3 take no such flag). An entry point refuses
// a flag it does not know.
enum : int { F_SHADOW = 1, F_DSPEC = 2, F_CULL = 4, F_GGX = 8, F_SOFT = 16, F_RESID = 32 };
constexpr int kKnownFlags = F_SHADOW | F_DSPEC | F_CULL | F_GGX | F_SOFT | F_RESID;

constexpr int kBlock = 256;
constexpr int kTriCols = 9;    // v0, e1, e2
constexpr int kLightCols = 16;
constexpr int kTabCols = 32;
// Shading-row layout (megakernel.py _V0.._NS). The forward kernels do not
// read columns 0-8 (v0, e1, e2): the winner's (t, u, v) come from their
// intersection loop. The backward kernels recompute (t, u, v) from them.
constexpr int kV0 = 0, kE1 = 3, kE2 = 6;
constexpr int kN0 = 9, kN1 = 12, kN2 = 15;
constexpr int kKD = 18, kKS = 21, kKE = 24, kNS = 27;
// Light columns (megakernel.py _L*).
constexpr int kLPos = 0, kLDir = 3, kLType = 6, kLInt = 7, kLAtt = 8, kLCut = 9;
// Camera vector (megakernel.py _CAM_*).
constexpr int kCamPos = 0, kCamRight = 3, kCamUp = 6, kCamFront = 9;

constexpr float kDetEps = 1e-10f;
constexpr float kBig = 3.0e38f;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kInvPi = 0.3183098861837907f;
constexpr float kHalfInvPi = 0.15915494309189535f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 mk(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V3 ld3(const float* p) { return {p[0], p[1], p[2]}; }
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 operator*(float s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
// ops/linalg.normalize: a * (1 / sqrt(max(a.a, 1e-20))).
__device__ __forceinline__ V3 normalize(V3 a) {
  return a * (1.0f / sqrtf(fmaxf(dot(a, a), 1e-20f)));
}
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// lowbias32 (ops/rng.mix_u32).
__device__ __forceinline__ uint32_t mix_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// ops/rng.uniform(seed, counter) with cm = premix(counter): top 24 bits.
__device__ __forceinline__ float uniform_cm(uint32_t seed, uint32_t cm) {
  return (float)(mix_u32(seed ^ cm) >> 8) * (1.0f / 16777216.0f);
}

// d max(x, c) / dx, with jnp.maximum's rule at a tie: each side takes half.
__device__ __forceinline__ float dmax(float x, float c) {
  return x > c ? 1.0f : (x == c ? 0.5f : 0.0f);
}
// d min(x, c) / dx, halved at a tie like jnp.minimum.
__device__ __forceinline__ float dmin(float x, float c) {
  return x < c ? 1.0f : (x == c ? 0.5f : 0.0f);
}

// Where each known-value residual row of a ray sits (ops/known.py:layout,
// the JAX package's emission order): row k of the ray of rank r at
// resid[k * R + r], where r is the ray's rank among the rays of the bounce
// that are alive and have a winner, in ray order (rank[j], -1 for the
// others), so a warp of ranked rays stores and loads each row on
// consecutive words. Row 0 is the winner's 1 / det, row 1 the inverse
// length of its normal, then the coverage (soft edges), the pick, the
// ONB's inverse length and
// the diffuse block (cos phi sin t, sin phi sin t, cos t, the direction's
// inverse length). The specular block holds (Blinn) log u2, cos_h, sin_h,
// cos phi, sin phi, the half vector's inverse length, cos^alpha,
// roughness, or (GGX) roughness, clamped u2, cos_h, sin_h, cos phi, sin
// phi, the half vector's inverse length. Light li's rows start at light +
// li * per_light: its distance and, with direct specular, the half
// vector's inverse length, the Blinn-Phong power and the log of its base.
// The kernels write and read only the rows K4 replays from
// (shade.cuh:shade, kResid): the inverse lengths stay unwritten,
// and a light's rows are written for the rays whose path goes on.
struct Rows {
  int cov, pick, d_cp, d_sp, d_ct, spec, light, per_light, n;
};
enum : int { kInvDet = 0 };
enum : int { kBLogU2 = 0, kBCosH, kBSinH, kBCphi, kBSphi, kBCosn = 6, kBRough };
enum : int { kGRough = 0, kGU2c, kGCosH, kGSinH, kGCphi, kGSphi };
enum : int { kLDist = 0, kLPow = 2, kLLog };

__host__ __device__ __forceinline__ Rows rows_of(int flags, int num_lights) {
  Rows r;
  int k = 2;                        // 0: 1 / det, 1: the normal's inverse length
  r.cov = (flags & F_SOFT) ? k++ : -1;
  r.pick = k++;
  k++;                              // the ONB's inverse length
  r.d_cp = k++;
  r.d_sp = k++;
  r.d_ct = k++;
  k++;                              // the diffuse direction's inverse length
  r.spec = k;
  k += (flags & F_GGX) ? 7 : 8;
  r.light = k;
  r.per_light = (flags & F_DSPEC) ? 4 : 1;
  r.n = k + num_lights * r.per_light;
  return r;
}

// Whether row k of the layout is one the kernels write (not an inverse
// length).
__host__ __device__ __forceinline__ bool row_written(const Rows& rl, int k, int flags) {
  if (k == 1 || k == rl.pick + 1 || k == rl.d_ct + 1) return false;
  if (k == rl.spec + ((flags & F_GGX) ? 6 : 5)) return false;  // the half vector's
  return !(rl.per_light == 4 && k >= rl.light && (k - rl.light) % 4 == 1);
}

}  // namespace
