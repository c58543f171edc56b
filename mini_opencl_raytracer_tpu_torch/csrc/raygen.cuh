// Jittered pinhole raygen of one pixel (ops/camera.rays_from_basis after
// ops/rng.pixel_seeds), shared by the mega path's K1 (megakernel.cu:
// bounce0_fwd_kernel), its adjoint K3 (megakernel_bwd.cu:
// bounce0_bwd_kernel, which also keeps the unnormalised direction and the
// screen coordinates for raygen_adj) and the wavefront's raygen kernel
// (raygen.cu). The arithmetic follows the plain version operation for
// operation, so seeds, origins and directions are its bits.
#pragma once

#include "megakernel.cuh"

namespace {

struct Raygen {
  V3 o, d, draw;
  float x, y;
  uint32_t seed;
};

// ``cam`` is the camera vector (position, right, up, front;
// ops/cuda/megakernel.py:camera_vector); ``frame_cm`` the frame's premix.
__device__ __forceinline__ Raygen raygen(const MegaParams& p, const float* cam, int pid,
                                         uint32_t frame_cm) {
  Raygen r;
  r.seed = mix_u32((uint32_t)pid ^ frame_cm);
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

}  // namespace
