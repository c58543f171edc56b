// The backward of the per-triangle material gather for Hopper (sm_90a):
// d_packed [M, 10] = the sum, by material, of the cotangent rows [T, 10]
// of ops/shading.py:material_rows (Kd, Ks, Ke, Ns of each triangle's
// material, gathered from the packed [M, 10] material block).
//
// Not a TPU kernel: the counterpart of the VJP of jnp.take in the JAX
// package's build_shading_table, which XLA lowers to a scatter-add. In
// PyTorch the gather's backward is index_put_(accumulate=True), a
// sort-based kernel that gives each distinct index to one warp, which walks
// that index's rows one after another; on a mesh that is one material over
// most of its triangles (a scan, a CAD part) that is one serial walk of
// ~T rows (12 ms for a 3-wide column at T = 69,732 on the H100).
//
// The work. The grid follows T and M: block (b, y) takes the contiguous
// rows [b * rows, (b + 1) * rows) in triangle order, kBlock at a time (a
// round; thread i takes row base + i), and the materials of slice y,
// [y * kSliceMats, (y + 1) * kSliceMats); a row of another slice's
// material is not read. In a round:
//   * the lanes of a warp that share a material form a group
//     (__match_any_sync); the group's 10 columns are summed in registers
//     by a fixed pairwise tree over the members' rank in lane order (step
//     s adds rank r + s into rank r for r % 2s == 0), as
//     csrc/megakernel_bwd.cu sums the table rows of K3 / K4; each group's
//     leader (rank 0) stages its sum in shared memory;
//   * the block adds the staged sums into its private partial of the
//     slice's materials in shared memory: warp w takes the materials with
//     m % kWarps == w, each material's sums in staging order (warp, then
//     lane), one lane a column.
// Each block writes its partial to its slice's columns of part [G, M * 10];
// the second launch sums column j of the G partials: warp k takes blocks
// k, k + 8, ... in block order, then a fixed pairwise tree over the 8
// warps (finish_kernel's order). No float atomics: which row
// lands in which block, round and lane follows from T, M and the block
// size alone, so the gradient is the same bits from run to run and in
// every replay of a captured graph.
//
// The cotangent is read in place through its strides (st, sc): the
// wavefront's is columns 24-33 of the [T, 34] table gradient (st = 34,
// sc = 1), the mega path's a slice of the transposed [C_PAD, T_pad] table
// gradient (st = 1, sc = C_PAD), each a view that autograd hands over. A
// negative index counts from the end, as torch's gather does; an index
// outside [-M, M) adds nothing (the forward's gather refuses it). float
// and double cotangents each have their instantiation; the sums are in
// the cotangent's type.
//
// Shared memory: a block holds the partial of its slice and a round's
// staging, (min(M, kSliceMats) + kBlock) * 10 values (91 KB in float, 181
// KB in double at a full slice). A scene of more than kSliceMats materials
// takes ceil(M / kSliceMats) slices, each reading the rows of its own
// materials. Rows a block takes: kBlock * max(4, ceil(M / 64)), so the
// partials (G * M * 10 values) stay under ~10 bytes a triangle however
// large M is.
//
// What bounds it: bytes. It must read each row's 10 floats and its index
// once (48 B a triangle: 3.35 MB, 1.0 us on the H100 at T = 69,732) and
// write M * 10 sums; a strided row drags its 32-byte sectors in whole (the
// [T, 34] gradient: ~9.5 MB). The launches themselves (~2-3 us each) are
// most of its time at that size.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kCols = 10;
constexpr int kSliceMats = 2048;
constexpr unsigned kFull = 0xffffffffu;

// Dynamic shared memory of a block: the partial of mats materials, the
// staged sums and their materials.
template <typename F>
__host__ __device__ constexpr size_t smem_bytes(int mats) {
  return (size_t)(mats + kBlock) * kCols * sizeof(F) + kBlock * sizeof(int);
}

template <typename F>
__global__ void __launch_bounds__(kBlock)
material_rows_bwd_kernel(int T, int M, int rows, const F* __restrict__ cot, long long st,
                         long long sc, const long long* __restrict__ mat,
                         F* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char raw[];  // one name for both types
  const int lo = blockIdx.y * kSliceMats;
  const int mats = min(M - lo, kSliceMats);
  F* acc = reinterpret_cast<F*>(raw);                          // [mats * kCols]
  F* stage = acc + (size_t)mats * kCols;                       // [kBlock * kCols]
  int* win = reinterpret_cast<int*>(stage + kBlock * kCols);   // [kBlock]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  for (int i = tid; i < mats * kCols; i += kBlock) acc[i] = F(0);
  const long long begin = (long long)blockIdx.x * rows;
  const long long end = min(begin + rows, (long long)T);
  for (long long base = begin; base < end; base += kBlock) {
    const long long t = base + tid;
    int m = -1;  // the material's index in this slice
    if (t < end) {
      long long k = mat[t];
      if (k < 0) k += M;
      k -= lo;
      m = (k >= 0 && k < mats) ? (int)k : -1;
    }
    F row[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) row[c] = m >= 0 ? cot[t * st + c * sc] : F(0);
    // The group's sum, by a pairwise tree in rank order.
    const unsigned grp = __match_any_sync(kFull, m >= 0 ? m : -1 - lane);
    const int rank = __popc(grp & below);
    const unsigned above = grp & ~below & ~(1u << lane);
    int nxt = above ? __ffs(above) - 1 : -1;  // the member of rank + s
    for (int s = 1; s < 32; s <<= 1) {
      const bool take = nxt >= 0 && (rank & (2 * s - 1)) == 0;
      if (!__any_sync(kFull, take)) break;
      const int src = nxt >= 0 ? nxt : lane;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const F o = __shfl_sync(kFull, row[c], src);
        if (take) row[c] += o;
      }
      const int nn = __shfl_sync(kFull, nxt, src);
      nxt = nxt >= 0 ? nn : -1;
    }
    const bool lead = m >= 0 && rank == 0;
    win[tid] = lead ? m : -1;
    if (lead) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) stage[tid * kCols + c] = row[c];
    }
    __syncthreads();
    // Into the partial: this warp's materials, in staging order.
    for (int b = 0; b < kBlock; b += 32) {
      const int x = win[b + lane];
      unsigned own = __ballot_sync(kFull, x >= 0 && (x & (kWarps - 1)) == warp);
      while (own) {
        const int e = b + __ffs(own) - 1;
        own &= own - 1;
        if (lane < kCols) acc[win[e] * kCols + lane] += stage[e * kCols + lane];
      }
    }
    __syncthreads();
  }
  __syncthreads();
  F* out = part + (size_t)blockIdx.x * M * kCols + (size_t)lo * kCols;
  for (int i = tid; i < mats * kCols; i += kBlock) out[i] = acc[i];
}

// The second launch: column j of the G block partials, summed by 8 warps
// (warp k takes blocks k, k + 8, ... in order), then over the warps by a
// fixed pairwise tree. G = 0 writes zeros.
template <typename F>
__global__ void __launch_bounds__(kBlock)
material_rows_finish_kernel(const F* __restrict__ part, int G, long long n,
                            F* __restrict__ out) {
  __shared__ F red[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long col = (long long)blockIdx.x * 32 + lane;
  F v = F(0);
  if (col < n)
    for (int g = warp; g < G; g += kWarps) v += part[(size_t)g * n + col];
  red[warp][lane] = v;
  __syncthreads();
  for (int h = kWarps / 2; h > 0; h >>= 1) {
    if (warp < h) red[warp][lane] += red[warp + h][lane];
    __syncthreads();
  }
  if (warp == 0 && col < n) out[col] = red[0][lane];
}

template <typename F>
int launch(int T, int M, int rows, const void* cot, long long st, long long sc,
           const long long* mat, void* part, void* d_packed, cudaStream_t s) {
  const int grid = (int)(((long long)T + rows - 1) / rows);
  const int slices = (M + kSliceMats - 1) / kSliceMats;
  if (grid > 0) {
    static bool ready = false;  // once a type: allow a full slice's partial
    if (!ready) {
      const cudaError_t e = cudaFuncSetAttribute(
          material_rows_bwd_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem_bytes<F>(kSliceMats));
      if (e != cudaSuccess) return (int)e;
      ready = true;
    }
    const dim3 blocks(grid, slices);
    material_rows_bwd_kernel<F><<<blocks, kBlock, smem_bytes<F>(M < kSliceMats ? M : kSliceMats),
                                  s>>>(T, M, rows, static_cast<const F*>(cot), st, sc, mat,
                                       static_cast<F*>(part));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const long long n = (long long)M * kCols;
  material_rows_finish_kernel<F><<<(unsigned)((n + 31) / 32), kBlock, 0, s>>>(
      static_cast<const F*>(part), grid, n, static_cast<F*>(d_packed));
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (ops/cuda/build.py). f64: 0 for float, 1 for double, the
// type of cot, part and d_packed. cot: the [T, 10] cotangent, element
// (t, c) at cot[t * st + c * sc]; mat: [T] int64 material indices; rows:
// the rows a block takes, a positive multiple of 256; part: [G, M * 10]
// with G = ceil(T / rows), written whole by the first launch; d_packed:
// [M, 10] contiguous, written whole. Launches two kernels on the given
// stream (one when T = 0), does not synchronise, and returns the first
// cudaError_t that is not cudaSuccess.
extern "C" int mrt_material_rows_bwd(int T, int M, int rows, int f64, const void* cot,
                                     long long st, long long sc, const long long* mat,
                                     void* part, void* d_packed, void* stream) {
  if (T < 0 || M < 1 || (M + kSliceMats - 1) / kSliceMats > 65535 || rows < kBlock ||
      rows % kBlock != 0 || (f64 != 0 && f64 != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return f64 ? launch<double>(T, M, rows, cot, st, sc, mat, part, d_packed, s)
             : launch<float>(T, M, rows, cot, st, sc, mat, part, d_packed, s);
}
