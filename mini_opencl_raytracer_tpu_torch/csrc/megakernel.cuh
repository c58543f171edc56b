// Device helpers shared by the forward (megakernel.cu) and backward
// (megakernel_bwd.cu) bounce kernels: the launch parameters, the float3
// arithmetic, the lowbias32 RNG and the column layouts of the tables.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Must match ops/cuda/megakernel.py:_Params field for field.
struct MegaParams {
  int num_rays, num_tris, num_lights, flags;
  int width, height;
  float t_max, ray_eps, emission_scale, spec_threshold, inv_soft_sigma;
  float sky[3];
  float tan_half_fov, inv_w, inv_h, aspect;
  uint32_t cms[5];
  uint32_t rg_jx, rg_jy, rg_frame;
};

namespace {

enum : int { F_SHADOW = 1, F_DSPEC = 2, F_CULL = 4, F_GGX = 8, F_SOFT = 16 };

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

}  // namespace
