// The wavefront's shading of one bounce, after its closest hit, as one
// kernel for Hopper (sm_90a), where no gradient is taken
// (ops/integrator.make_bounce_core routes to it; ops/cuda/shade.py wraps it).
//
// Not the port of a TPU kernel: the JAX package's wavefront computes
// ops/shading.hit_attributes and ops/integrator.shade_hit as XLA ops, which
// XLA fuses. In PyTorch they are ~520 elementwise launches a bounce over
// [R, 3] and [R] tensors, ~7.1 KB of traffic a ray: both BRDF lobes for
// every ray, each dot and cross a launch over strided views. This kernel is
// both in one pass, one thread a ray:
//   * hit_attributes: the winner's row of the [T, 34] ShadingTable, the
//     (t, u, v) recompute on (v0, v1 - v0, v2 - v0) as
//     ops/intersect.ray_triangle_edges does it (1 / det where |det| > 1e-10,
//     det > 1e-10 under culling, else 0; t = inf where the recompute's own
//     tests fail), the interpolated normal;
//   * shade_hit: the shading body of the mega path's K1 / K2 (shade.cuh),
//     on the ShadingTable's layout (TableRow) and with the radiance carried
//     (kCarry): each of the bounce's radiance terms is one float add to the
//     carry, in shade_hit's order, so every output is shade_hit's, bit for
//     bit. Only the lobe the roulette picks is evaluated (shade_hit computes
//     both and selects one): the values are the same, the other lobe's work
//     is gone.
// Built with -fmad=false like the other kernels (ops/cuda/build.py), so it
// rounds as the PyTorch ops do on the card. No shadow rays: the any-hit
// call sits inside the light loop, and the wrapper refuses the flag.
//
// What bounds it: bytes. A ray reads o, d, beta and the radiance (48 B),
// alive and hit (2), its seed (8) and its winner's row (136), and writes o,
// d, beta, the radiance and alive (49): ~243 B, 2.0 GB at sponza 4K's 8.29 M
// rays, 0.60 ms at 3.35 TB/s. Its arithmetic (one lobe, a few dozen
// transcendentals a ray) is far below the card's rate.
//
// What the design does about it:
//   * with the rows the intersector fetched (K6's Hit.rows, [R, 34] in ray
//     order), a warp's 32 rows are 4,352 contiguous bytes: the warp copies
//     them into shared memory with 16-byte loads, where one of its rays is
//     alive with a winner, and each lane reads its own row there;
//   * without rows (K5, the LBVH walk), a ray with a winner reads its row
//     of the table at its index; rays without one read no row;
//   * the lights ([L, 16], ops/cuda/megakernel.py pack_lights) are read from
//     device memory, every lane the same row: any number of lights;
//   * the five RNG counters of the bounce are premixed on the host
//     (MegaParams.cms), the seeds read as the wavefront's int64 u32 values,
//     alive and hit as bytes: no conversion launch in front of the kernel;
//   * rays that are not alive pass their state through.

#include "shade.cuh"

namespace {

constexpr int kShadeBlock = 128;

__device__ __forceinline__ void st3(float* p, V3 a) {
  p[0] = a.x;
  p[1] = a.y;
  p[2] = a.z;
}

// hit_attributes' (t, u, v) on the winner's row: ops/intersect
// .ray_triangle_edges on (v0, v1 - v0, v2 - v0), operation for operation.
__device__ __forceinline__ void winner_point(const float* row, V3 o, V3 d, bool cull, float& t,
                                             float& u, float& v) {
  const V3 v0 = ld3(row + TableRow::kV0);
  const V3 e1 = ld3(row + TableRow::kV1) - v0;
  const V3 e2 = ld3(row + TableRow::kV2) - v0;
  const V3 pvec = cross(d, e2);
  const float det = dot(e1, pvec);
  const bool ok = cull ? det > kDetEps : fabsf(det) > kDetEps;
  const float inv = ok ? 1.0f / det : 0.0f;
  const V3 tvec = o - v0;
  u = dot(tvec, pvec) * inv;
  const V3 qvec = cross(tvec, e1);
  v = dot(d, qvec) * inv;
  t = dot(e2, qvec) * inv;
  if (!(ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f)) t = __int_as_float(0x7f800000);
}

// One thread a ray. kRows: ``rows`` is the intersector's [R, 34] rows;
// else the [T, 34] table, read at ``tri_idx``. The rows of o, d, beta and
// the radiance are ``so``, ``sd``, ``sb`` and ``sr`` floats apart (0 for the
// camera's broadcast origin, 12 for the pipeline stages' packed state),
// the outputs' 3.
template <bool kRows>
__global__ void __launch_bounds__(kShadeBlock, 8)
shade_kernel(MegaParams p, const float* __restrict__ rows, const long long* __restrict__ tri_idx,
             const bool* __restrict__ hit_in, const bool* __restrict__ alive_in,
             const long long* __restrict__ seeds, const float* __restrict__ lights,
             const float* __restrict__ o_in, long long so, const float* __restrict__ d_in,
             long long sd, const float* __restrict__ beta_in, long long sb,
             const float* __restrict__ rad_in, long long sr, float* __restrict__ o_out,
             float* __restrict__ d_out, float* __restrict__ beta_out,
             float* __restrict__ rad_out, bool* __restrict__ alive_out) {
  constexpr int C = TableRow::kCols;
  __shared__ __align__(16) float s_rows[kRows ? kShadeBlock * C : 1];
  const int R = p.num_rays, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kShadeBlock + threadIdx.x;
  const bool alive = i < R && alive_in[i];
  const bool hit = alive && hit_in[i];
  const float* tab = rows;  // where the winner's row is, at ``best``
  int best = -1;
  if constexpr (kRows) {
    float* s = s_rows + (threadIdx.x - lane) * C;
    if (__any_sync(kFull, hit)) {  // the warp's rows, whole
      const int first = i - lane;
      const int n = min(32, R - first) * C;
      const float* g = rows + (size_t)first * C;
      for (int k = lane; k < n / 4; k += 32)
        reinterpret_cast<float4*>(s)[k] = __ldg(reinterpret_cast<const float4*>(g) + k);
      for (int k = n / 4 * 4 + lane; k < n; k += 32) s[k] = g[k];
      __syncwarp();
    }
    tab = s;
    best = hit ? lane : -1;
  } else {
    best = hit ? (int)tri_idx[i] : -1;
  }
  if (i >= R) return;
  const V3 o = ld3(o_in + i * so), d = ld3(d_in + i * sd);
  const V3 beta = ld3(beta_in + i * sb), rad = ld3(rad_in + i * sr);
  RayOut r = pass_through(o, d, beta);
  r.rad = rad;
  if (alive) {
    float t = 0.0f, u = 0.0f, v = 0.0f;
    if (hit) winner_point(tab + (size_t)best * C, o, d, p.flags & F_CULL, t, u, v);
    int tests = 0;
    r = shade<false, false, TableRow, true>(p, nullptr, lights, tab, o, d, beta, true,
                                            (uint32_t)seeds[i], tests, best, t, u, v, 0.0f,
                                            nullptr, 0, rad);
  }
  st3(o_out + 3 * (size_t)i, r.o);
  st3(d_out + 3 * (size_t)i, r.d);
  st3(beta_out + 3 * (size_t)i, r.beta);
  st3(rad_out + 3 * (size_t)i, r.rad);
  alive_out[i] = r.alive;
}

}  // namespace

// C entry point (ops/cuda/build.py). p: the bounce's MegaParams
// (ops/cuda/megakernel.py _params; num_tris is not read). rows: the
// intersector's [R, 34] rows, 16-byte aligned, or null, and then table
// [T, 34] and tri_idx [R] int64 give each winner's row. hit, alive, alive_out:
// [R] bool; seeds: [R] int64 holding u32 values; lights: [L, 16]; o, d, beta,
// rad: [R, 3] with rows so, sd, sb, sr floats apart; the outputs: [R, 3]
// contiguous. Flags: direct specular, culling, GGX, soft edges; shadow
// rays and residual rows are refused. Launches on the given stream, does
// not synchronise, and returns the launch's cudaError_t.
extern "C" int mrt_shade(const MegaParams* p, const float* rows, const float* table,
                         const long long* tri_idx, const bool* hit, const bool* alive,
                         const long long* seeds, const float* lights, const float* o,
                         long long so, const float* d, long long sd, const float* beta,
                         long long sb, const float* rad, long long sr, float* o_out,
                         float* d_out, float* beta_out, float* rad_out, bool* alive_out,
                         void* stream) {
  if (p->num_rays <= 0) return 0;
  if ((p->flags & ~(F_DSPEC | F_CULL | F_GGX | F_SOFT)) || p->num_lights < 0 ||
      (!rows && !(table && tri_idx)))
    return (int)cudaErrorInvalidValue;
  const int grid = (p->num_rays + kShadeBlock - 1) / kShadeBlock;
  const cudaStream_t s = (cudaStream_t)stream;
  if (rows)
    shade_kernel<true><<<grid, kShadeBlock, 0, s>>>(*p, rows, nullptr, hit, alive, seeds, lights,
                                                    o, so, d, sd, beta, sb, rad, sr, o_out,
                                                    d_out, beta_out, rad_out, alive_out);
  else
    shade_kernel<false><<<grid, kShadeBlock, 0, s>>>(*p, table, tri_idx, hit, alive, seeds,
                                                     lights, o, so, d, sd, beta, sb, rad, sr,
                                                     o_out, d_out, beta_out, rad_out, alive_out);
  return (int)cudaGetLastError();
}
