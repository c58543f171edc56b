// The adjoint of the wavefront's fused shading (shade.cu) for Hopper
// (sm_90a): the vector-Jacobian product of one bounce after its closest hit,
// with the winner, the alive mask and the hit mask held fixed, where a
// gradient is taken (ops/cuda/shade.py's autograd Function; ops/integrator
// .make_bounce_core routes to it).
//
// Not the port of a TPU kernel: the JAX package differentiates
// ops/shading.hit_attributes and ops/integrator.shade_hit with jax.vjp, and
// XLA fuses the result. In PyTorch, autograd's backward of those ~520 ops a
// bounce is as many launches again. This kernel is their VJP in one pass,
// one thread a ray: ray_adjoint (adjoint.cuh), the mega path's K3 / K4
// adjoint, on the ShadingTable's row layout (TableRow). The radiance is
// carried (each of the bounce's terms is one add to it), so its cotangent
// passes through unchanged: the wrapper returns it, and this kernel does not
// touch it. The body of ray_adjoint is unchanged, so each term's derivative
// is K4's.
//
// Per ray, written densely with no reduction: d o, d d, d beta [R, 3], and
// the winner row's gradient [R, 34] in the ShadingTable's columns (TableRow:
// d v1 = d e1, d v2 = d e2, d v0 = d v0 - d e1 - d e2, the UV columns 0;
// rays without a winner write a row of zeros). The wrapper hands the rows'
// gradient to the gather that fetched them (ops/shading._PrecomputedRows or
// take_rows), which sums it into the table.
//
// The light gradients [L, 16] are a sum over rays: each light's 10 columns
// are summed over a warp by a butterfly of shuffles (ray_adjoint), lane 0
// adds them to its warp's row in shared memory, tile after tile, the block
// sums its warps' rows in warp order into its partial row, and
// finish_kernel (adjoint.cuh), a second launch, sums the G partial rows in
// a fixed order. No atomics: the order of every sum follows from the data
// and G, so a repeated call gives equal bits.
//
// The work. A persistent grid of G blocks of kBlock rays (two per SM, the
// wrapper's choice, as K4) walks the tiles of the rays, block b taking
// tiles b, b + G, ... Where one of a warp's rays is alive with a winner,
// the warp copies its 32 rows (4,352 contiguous bytes) into shared memory
// with 16-byte loads, as shade.cu does, and each lane reads its own row
// there; it then writes the 32 rows' gradients there and stores them with
// 16-byte stores. A warp with no winner stores zeros.
//
// What bounds it: bytes. A ray reads o, d, beta (36 B), alive and hit (2),
// its seed (8) and four cotangents (48), and writes d o, d d, d beta (36)
// and its row's gradient (136); a ray with a winner also reads its row
// (136): 89 MB at config 3's bounce 0 (262,144 rays, 166,224 with a
// winner), 0.027 ms at 3.35 TB/s. As K4, it issues more than it moves (the
// adjoint of a ray with a winner is ~7k instructions): on the H100 it
// takes 0.073 ms there, 36% of that bound (PERF.md).
//
// Built with the forward kernels' flags (no fast-math, -fmad=false).

#include "adjoint.cuh"

namespace {

constexpr int kRowCols = TableRow::kCols;

// The pointers and row strides of an adjoint launch.
struct ShadeBwdIO {
  const float* rows;  // [R, 34], 16-byte aligned: each ray's winner row
  const bool *hit, *alive;
  const long long* seeds;  // [R], u32 values
  const float* lights;     // [L, 16]
  const float *o, *d, *beta;
  long long so, sd, sb;
  const float *co, *cd, *cb, *cr;  // cotangents of the outputs o, d, beta, radiance
  long long sco, scd, scb, scr;
  float *d_o, *d_d, *d_beta;  // [R, 3]
  float* d_rows;              // [R, 34], 16-byte aligned
  float* part;                // [gridDim.x, L * 16] block partials
};

__device__ __forceinline__ void st3(float* p, V3 a) {
  p[0] = a.x;
  p[1] = a.y;
  p[2] = a.z;
}

// A lane's row gradient in the ShadingTable's columns, at ``s``
// (shared memory), from ray_adjoint's 28 columns in MegaRow's order.
__device__ __forceinline__ void table_row_grad(float* s, const float (&g)[kRowGrads]) {
  for (int k = 0; k < 3; ++k) {
    s[TableRow::kV0 + k] = g[kV0 + k] - g[kE1 + k] - g[kE2 + k];
    s[TableRow::kV1 + k] = g[kE1 + k];
    s[TableRow::kV2 + k] = g[kE2 + k];
    s[TableRow::kN0 + k] = g[kN0 + k];
    s[TableRow::kN1 + k] = g[kN1 + k];
    s[TableRow::kN2 + k] = g[kN2 + k];
    s[TableRow::kKD + k] = g[kKD + k];
    s[TableRow::kKS + k] = g[kKS + k];
    s[TableRow::kKE + k] = g[kKE + k];
  }
  for (int k = TableRow::kN2 + 3; k < TableRow::kKD; ++k) s[k] = 0.0f;  // the UVs
  s[TableRow::kNS] = g[kNS];
}

__global__ void __launch_bounds__(kBlock, 2) shade_bwd_kernel(MegaParams p, ShadeBwdIO io) {
  __shared__ float s_lights[kMaxLights * kLightCols];
  __shared__ float s_lg[kWarps * kMaxLights * kLightGrads];  // per-warp light gradients
  __shared__ __align__(16) float s_rows[kBlock * kRowCols];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int R = p.num_rays, L = p.num_lights;
  for (int k = tid; k < L * kLightCols; k += kBlock) s_lights[k] = io.lights[k];
  for (int k = tid; k < kWarps * kMaxLights * kLightGrads; k += kBlock) s_lg[k] = 0.0f;
  __syncthreads();
  float* s = s_rows + (tid - lane) * kRowCols;  // the warp's 32 rows
  float* lg = s_lg + warp * kMaxLights * kLightGrads;
  const int tiles = (R + kBlock - 1) / kBlock;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int i = tile * kBlock + tid;
    const int first = i - lane;
    // The warp's rays in range, and their floats in the row arrays.
    const int n = (first < R ? min(32, R - first) : 0) * kRowCols;
    const bool in = i < R;
    const bool alive = in && io.alive[i];
    const bool hit = alive && io.hit[i];
    const bool rows_in = __any_sync(kFull, hit);
    if (rows_in) {
      const float* g = io.rows + (size_t)first * kRowCols;
      for (int k = lane; k < n / 4; k += 32)
        reinterpret_cast<float4*>(s)[k] = __ldg(reinterpret_cast<const float4*>(g) + k);
      for (int k = n / 4 * 4 + lane; k < n; k += 32) s[k] = g[k];
      __syncwarp();
    }
    V3 o = zero3(), d = zero3(), beta = zero3();
    Cot c = {zero3(), zero3(), zero3(), zero3()};
    uint32_t seed = 0;
    if (in) {
      o = ld3(io.o + i * io.so);
      d = ld3(io.d + i * io.sd);
      beta = ld3(io.beta + i * io.sb);
      c = {ld3(io.co + i * io.sco), ld3(io.cd + i * io.scd), ld3(io.cb + i * io.scb),
           ld3(io.cr + i * io.scr)};
      seed = (uint32_t)io.seeds[i];
    }
    float row[kRowGrads];
#pragma unroll
    for (int k = 0; k < kRowGrads; ++k) row[k] = 0.0f;
    V3 g_o, g_d, g_beta;
    ray_adjoint<false, TableRow>(p, s_lights, s, o, d, beta, alive, seed, hit ? lane : -1, 0, c,
                                 g_o, g_d, g_beta, row, lg, RowsIn{nullptr, 0, 0});
    if (in) {
      st3(io.d_o + 3 * (size_t)i, g_o);
      st3(io.d_d + 3 * (size_t)i, g_d);
      st3(io.d_beta + 3 * (size_t)i, g_beta);
    }
    float* g = io.d_rows + (size_t)first * kRowCols;
    if (rows_in) {  // every lane has read its row: the gradients take its place
      __syncwarp();
      table_row_grad(s + lane * kRowCols, row);
      __syncwarp();
      for (int k = lane; k < n / 4; k += 32)
        reinterpret_cast<float4*>(g)[k] = reinterpret_cast<const float4*>(s)[k];
      for (int k = n / 4 * 4 + lane; k < n; k += 32) g[k] = s[k];
    } else {
      for (int k = lane; k < n / 4; k += 32)
        reinterpret_cast<float4*>(g)[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int k = n / 4 * 4 + lane; k < n; k += 32) g[k] = 0.0f;
    }
    __syncwarp();  // the next tile's rows overwrite these
  }
  __syncthreads();
  // The block's partial row: each light column summed over the warps in warp
  // order (type and pad columns 0).
  float* part = io.part + (size_t)blockIdx.x * L * kLightCols;
  for (int k = tid; k < L * kLightCols; k += kBlock) {
    const int li = k / kLightCols, col = k % kLightCols;
    float v = 0.0f;
    if (col < kLightGrads)
      for (int w = 0; w < kWarps; ++w) v += s_lg[(w * kMaxLights + li) * kLightGrads + col];
    part[k] = v;
  }
}

}  // namespace

// C entry point (ops/cuda/build.py). p: the bounce's MegaParams
// (ops/cuda/megakernel.py params; num_tris is not read). grid: the
// persistent blocks; part: their [grid, L * 16] partials, written whole by
// the first launch. rows: [R, 34], 16-byte aligned; hit, alive: [R] bool;
// seeds: [R] int64 holding u32 values; lights: [L, 16], L <= 30; o, d,
// beta, and the cotangents co, cd, cb, cr of the outputs o, d, beta and
// radiance: [R, 3] with rows the given floats apart. Out: d_o, d_d,
// d_beta [R, 3]; d_rows [R, 34] (16-byte aligned); d_lights
// [L, 16]. Flags: direct specular, culling, GGX, soft edges; shadow rays
// and residual rows are refused. Launches two kernels on the given stream,
// does not synchronise, and returns the first cudaError_t that is not
// cudaSuccess.
extern "C" int mrt_shade_bwd(const MegaParams* p, int grid, const float* rows, const bool* hit,
                             const bool* alive, const long long* seeds, const float* lights,
                             const float* o, long long so, const float* d, long long sd,
                             const float* beta, long long sb, const float* co, long long sco,
                             const float* cd, long long scd, const float* cb, long long scb,
                             const float* cr, long long scr, float* part, float* d_o,
                             float* d_d, float* d_beta, float* d_rows, float* d_lights,
                             void* stream) {
  if (p->num_rays <= 0) return 0;
  if ((p->flags & ~(F_DSPEC | F_CULL | F_GGX | F_SOFT)) || p->num_lights < 0 ||
      p->num_lights > kMaxLights || grid < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  ShadeBwdIO io = {rows, hit, alive, seeds, lights, o, d, beta, so, sd, sb, co, cd, cb, cr,
                   sco, scd, scb, scr, d_o, d_d, d_beta, d_rows, part};
  shade_bwd_kernel<<<grid, kBlock, 0, st>>>(*p, io);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p->num_lights == 0) return (int)e;
  const int n = p->num_lights * kLightCols;
  finish_kernel<<<(n + 31) / 32, kBlock, 0, st>>>(part, grid, n, 0, n, nullptr, d_lights,
                                                  nullptr);
  return (int)cudaGetLastError();
}
