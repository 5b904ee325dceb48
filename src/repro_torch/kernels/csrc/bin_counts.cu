// Bin counts for Hopper: the exact int32 column occupancy Z^T 1 of an ELL
// pattern, i.e. a histogram of idx.
//
// Replaces: src/repro/kernels/ops.py, bin_counts. Its Pallas route drives
// zt_matmul_pallas (src/repro/kernels/ell_spmm.py) with unit weights, in
// row slices of fewer than 2^22 rows so that float32 holds every count,
// and rounds each slice to int32: a TPU workaround this kernel does not
// keep.
//
// What it computes: out[c] (+)= #{(i, g) : idx[i, g] == c} for c in [0, d).
// Entries outside [0, d) are dropped, as the JAX scatter drops them.
//
// What bounds it on the card: bytes. It reads idx once (N * R * 4) and
// writes D * 4: at the covtype fit's shape (581,012 x 256, D = 524,288)
// 597 MB, 0.178 ms at 3.35 TB/s. One add per element is far below any
// rate limit.
//
// Design. The strip contract idx[i, g] in [g * d_g, (g + 1) * d_g) lets a
// block keep private int32 counters for a group of G consecutive grids in
// shared memory: G * d_g * 4 bytes, at most 64 KB (G = 8 at d_g 2,048, so
// three 512-thread blocks fit an SM). Blocks are laid out (row slice, grid
// group). A warp reads 32 consecutive (row, grid) elements of its group,
// i.e. 32 / G rows of G * 4 contiguous bytes, so every L2 sector it touches
// is used whole at G = 8. Each element is one shared-memory atomicAdd; at
// the end each nonzero counter goes to out with one global int32
// atomicAdd. An element off the strip contract goes straight to a global
// atomic. Integer adds do not depend on their order, so the counts are
// exact and the same on every run, whatever the launch order of the
// blocks. With accumulate = 0 the entry point zeroes out first
// (cudaMemsetAsync on the stream); with 1 it adds into out, so a sweep over
// row chunks adds into one (D,) buffer with no extra pass. A grid whose
// counters exceed what a block may hold in shared memory (d_g > 32,768),
// or a d_g that is not a power of two, takes a plain kernel of global
// atomics.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 512;
constexpr long long kGroupBytes = 64 * 1024;   // a grid group's counters
constexpr long long kSmemMax = 200 * 1024;     // one grid's, at most

__global__ void __launch_bounds__(kThreads)
    bin_counts_smem_kernel(const int* __restrict__ idx, int* __restrict__ out,
                           long long n, int r, int d_g, int log_g,
                           long long d, long long rows_per_block) {
  extern __shared__ int hist[];
  const int G = 1 << log_g;
  const int g0 = (int)blockIdx.y << log_g;
  const int gn = min(G, r - g0);
  const long long base = (long long)g0 * d_g;
  // the columns this block counts privately: [base, base + span)
  const int span = (int)max(0LL, min((long long)gn * d_g, d - base));
  for (int i = threadIdx.x; i < span; i += kThreads) hist[i] = 0;
  __syncthreads();
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const long long elems = max(0LL, min(rows_per_block, n - row0)) << log_g;
  const int* src = idx + row0 * r + g0;
  for (long long e = threadIdx.x; e < elems; e += kThreads) {
    const int gg = (int)(e & (G - 1));
    if (gg >= gn) continue;
    const int c = __ldcs(src + (e >> log_g) * r + gg);   // read once
    const long long local = (long long)c - base;
    if (local >= 0 && local < span)
      atomicAdd(&hist[local], 1);
    else if (c >= 0 && c < d)
      atomicAdd(out + c, 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < span; i += kThreads) {
    const int v = hist[i];
    if (v) atomicAdd(out + base + i, v);
  }
}

__global__ void __launch_bounds__(kThreads)
    bin_counts_global_kernel(const int* __restrict__ idx,
                             int* __restrict__ out, long long total,
                             long long d) {
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
       e < total; e += (long long)gridDim.x * kThreads) {
    const int c = __ldcs(idx + e);
    if (c >= 0 && c < d) atomicAdd(out + c, 1);
  }
}

}  // namespace

// idx: (n, r) int32, contiguous; out: (d,) int32. accumulate = 0 zeroes
// out first, 1 adds into it. Returns cudaGetLastError() after the launch
// (or the first CUDA error met before it).
extern "C" int bin_counts_launch(const void* idx, void* out, long long n,
                                 int r, int d_g, long long d, int accumulate,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
  if (!accumulate && d > 0) {
    e = cudaMemsetAsync(out, 0, (size_t)d * sizeof(int), st);
    if (e != cudaSuccess) return (int)e;
  }
  if (n <= 0 || r <= 0 || d <= 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  const long long grid_bytes = (long long)d_g * 4;
  if (d_g < 1 || (d_g & (d_g - 1)) || grid_bytes > kSmemMax) {
    const long long total = n * r;
    const long long blocks =
        std::min((total + kThreads - 1) / kThreads, (long long)sms * 8);
    bin_counts_global_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
        (const int*)idx, (int*)out, total, d);
    return (int)cudaGetLastError();
  }
  int log_g = 0;
  while (log_g < 3 && (grid_bytes << (log_g + 1)) <= kGroupBytes) ++log_g;
  const int groups = (r + (1 << log_g) - 1) >> log_g;
  const int smem = (int)(grid_bytes << log_g);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(bin_counts_smem_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
  }
  // two waves of blocks, as many as shared memory lets an SM hold, but at
  // least 4 * d_g rows a block so that counting outweighs the flush
  const long long per_sm =
      std::max(1LL, std::min(3LL, (228LL * 1024) / (smem + 1024)));
  long long slices = std::max(1LL, (long long)sms * per_sm * 2 / groups);
  slices = std::min(slices, std::max(1LL, n / (4LL * d_g)));
  const long long rows_per_block = (n + slices - 1) / slices;
  slices = (n + rows_per_block - 1) / rows_per_block;
  const dim3 grid((unsigned)slices, (unsigned)groups);
  bin_counts_smem_kernel<<<grid, kThreads, smem, st>>>(
      (const int*)idx, (int*)out, n, r, d_g, log_g, d, rows_per_block);
  return (int)cudaGetLastError();
}
