// The wavefront's ray generation as one kernel for Hopper (sm_90a): per
// pixel id, its seed and its jittered pinhole direction (ops/cuda/raygen.py
// wraps it and gives the origin as the camera's position, expanded;
// render.render_ids routes to it where no gradient of the camera is taken).
//
// Not the port of a TPU kernel: the JAX package's wavefront computes
// ops/rng.pixel_seeds and ops/camera.generate_rays as XLA ops, which XLA
// fuses. In PyTorch they are ~89 launches a frame over [R] and [R, 3]
// tensors, the lowbias32 hash in int64 masked to 32 bits (torch has no u32
// shift or add): ~1,160 B of traffic a ray. This kernel is the same
// arithmetic in one pass, one thread a ray: raygen() of raygen.cuh, which
// K1 and K3 compile too, so seeds and directions are the plain version's
// bits (built with -fmad=false, normalize as 1 / sqrtf).
//
// What bounds it: bytes. A ray reads its pixel id (4 B) and writes its seed
// as the wavefront's int64 u32 value (8 B) and its direction (12 B): 24 B,
// 199.1 MB at sponza 4K's 8,294,400 rays, 0.059 ms at 3.35 TB/s. The hash
// and a square root a ray are far below the card's rate. The origin is not
// written: a dense [R, 3] origin lives through the first bounce's shading,
// where the frame's memory peaks, and raised a sponza 4K image's peak by
// its 94.9 MiB on the H100 (the shading kernel and the plain version take
// the expanded position, row stride 0).
//
// What the design does about it:
//   * the ids are read and the seeds written by consecutive threads, 4 and
//     8 bytes each: whole lines a warp;
//   * a block's 256 directions are staged in shared memory (stride 3
//     floats: no bank conflict) and written as 16-byte words, 512
//     contiguous bytes a warp's store; a block's slice of d starts at a
//     multiple of 3,072 bytes, so its words are aligned;
//   * the frame's premix is one word in device memory (a captured launch
//     reads each replay's frame), the jitter counters premixed on the host.

#include "raygen.cuh"

namespace {

constexpr int kRaygenBlock = 256;
constexpr int kBlockFloats = 3 * kRaygenBlock;

__global__ void __launch_bounds__(kRaygenBlock)
raygen_kernel(MegaParams p, const uint32_t* __restrict__ frame_cm,
              const float* __restrict__ cam, const int* __restrict__ pixel_ids,
              long long* __restrict__ seeds, float* __restrict__ d) {
  __shared__ float4 s_d4[kBlockFloats / 4];
  float* s_d = reinterpret_cast<float*>(s_d4);
  const int t = threadIdx.x;
  const int base = blockIdx.x * kRaygenBlock;
  const int n = min(kRaygenBlock, p.num_rays - base);
  if (t < n) {
    const Raygen g = raygen(p, cam, pixel_ids[base + t], *frame_cm);
    seeds[base + t] = (long long)g.seed;
    s_d[3 * t] = g.d.x;
    s_d[3 * t + 1] = g.d.y;
    s_d[3 * t + 2] = g.d.z;
  }
  __syncthreads();
  // The block's 3n floats of d, from float 3 * base on: whole 16-byte
  // words, then the last floats of a ragged tail.
  const int nf = 3 * n;
  float* out = d + 3 * (size_t)base;
  float4* out4 = reinterpret_cast<float4*>(out);
  for (int w = t; w < nf / 4; w += kRaygenBlock) out4[w] = s_d4[w];
  for (int k = nf / 4 * 4 + t; k < nf; k += kRaygenBlock) out[k] = s_d[k];
}

}  // namespace

// Seeds [R] int64 and directions d [R, 3] float32 (contiguous, 16-byte
// aligned) of the pixel ids [R] int32; ``frame_cm`` the frame's premix, one
// word on the device; ``cam`` the [16] camera vector.
extern "C" int mrt_raygen(const MegaParams* p, const uint32_t* frame_cm, const float* cam,
                          const int* pixel_ids, long long* seeds, float* d, void* stream) {
  if (p->num_rays <= 0) return 0;
  if (p->width <= 0 || (uintptr_t)d % 16) return (int)cudaErrorInvalidValue;
  const int grid = (p->num_rays + kRaygenBlock - 1) / kRaygenBlock;
  raygen_kernel<<<grid, kRaygenBlock, 0, (cudaStream_t)stream>>>(*p, frame_cm, cam, pixel_ids,
                                                                  seeds, d);
  return (int)cudaGetLastError();
}
