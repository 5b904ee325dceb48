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
// rate limit, if the adds do not wait on each other.
//
// Design. The strip contract idx[i, g] in [g * d_g, (g + 1) * d_g) lets a
// block keep private int32 counters for a group of G consecutive grids in
// shared memory: G * d_g * 4 bytes, at most 128 KB (G = 16 at d_g 2,048;
// one 1,024-thread block an SM). Blocks are laid out (row slice, grid
// group), one wave of them; each warp of a block takes a contiguous run of
// the slice's rows.
//   Lanes own grids: lane l reads grid g0 + l % G of rows l / G, l / G +
//   32 / G, ... (a warp instruction reads 32 / G rows of G * 4 contiguous
//   bytes). Two lanes of a warp can meet on one counter only if they share
//   a grid, i.e. 32 / G lanes at most (2 at d_g 2,048; the old layout, 8
//   grids x 4 rows a warp, put 4 lanes on each grid).
//   Loads in flight: each lane loads 16 rows ahead (__ldcs: read once), so
//   a warp keeps 2 KB in flight; then one shared atomic an element. The
//   old kernel's one load in flight a thread, not its atomics, held it at
//   2.5x its bound. Measured on the H100, each lever alone (PERF.md):
//   one load in flight a lane takes 2.5x as long, 64 KB of counters a
//   block 1.45x; counting runs of equal bins in a register (1.05x) or
//   aggregating a warp's equal bins by __match_any_sync (5.3x) adds work
//   and saves nothing on the covtype-shaped pattern, so neither is kept.
// At the end each nonzero counter goes to out with one global int32
// atomicAdd. An element off the strip contract goes straight to a global
// atomic. Integer adds do not depend on their order, so the counts are
// exact and the same on every run, whatever the launch order of the
// blocks. With accumulate = 0 the entry point zeroes out first
// (cudaMemsetAsync on the stream); with 1 it adds into out, so a sweep over
// row chunks adds into one (D,) buffer with no extra pass. A grid whose
// counters exceed what a block may hold (d_g > 32,768), or a d_g that is
// not a power of two, takes a plain kernel of global atomics.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr long long kSmemMax = 128 * 1024;     // counters a block keeps
constexpr int kUnroll = 16;                    // rows a lane loads ahead

__global__ void __launch_bounds__(kThreads, 1)
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
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gl = lane & (G - 1);           // the lane's grid in the group
  const int rstep = 32 >> log_g;           // rows a warp instruction reads
  // the warp's rows: a contiguous run of the block's slice
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const long long rows = max(0LL, min(rows_per_block, n - row0));
  const long long per_warp = (rows + kWarps - 1) / kWarps;
  const long long w0 = row0 + warp * per_warp;
  const long long w1 = min(row0 + rows, w0 + per_warp);
  const bool has_grid = gl < gn;
  const int* col = idx + g0 + gl;
  // warp-uniform trip count: every lane takes every step
  for (long long i0 = w0; i0 < w1; i0 += (long long)rstep * kUnroll) {
    int c[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + (long long)u * rstep + (lane >> log_g);
      c[u] = (has_grid && i < w1) ? __ldcs(col + i * r) : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long local = (long long)c[u] - base;
      const bool mine = local >= 0 && local < span;
      if (!mine && c[u] >= 0 && c[u] < d) atomicAdd(out + c[u], 1);
      if (mine) atomicAdd(&hist[local], 1);
    }
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
        std::min((total + kThreads - 1) / kThreads, (long long)sms * 2);
    bin_counts_global_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
        (const int*)idx, (int*)out, total, d);
    return (int)cudaGetLastError();
  }
  // G grids a block: as many as its counters allow, at most 32 (one a
  // lane) and no more than R needs
  int log_g = 0;
  while (log_g < 5 && (grid_bytes << (log_g + 1)) <= kSmemMax &&
         (1 << log_g) < r)
    ++log_g;
  const int groups = (r + (1 << log_g) - 1) >> log_g;
  const int smem = (int)(grid_bytes << log_g);
  if (smem > 48 * 1024) {
    // a process-wide attribute, set before the first launch of the
    // kernel; setting it again is cheap and changes nothing
    e = cudaFuncSetAttribute(bin_counts_smem_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
  }
  // one wave of blocks, as many as an SM holds (at most 2 of 1,024
  // threads), but at least 4 * d_g rows a block so that counting outweighs
  // the flush of its G * d_g counters
  const long long per_sm =
      std::max(1LL, std::min(2LL, (228LL * 1024) / (smem + 1024)));
  long long slices = std::max(1LL, (long long)sms * per_sm / groups);
  slices = std::min(slices, std::max(1LL, n / (4LL * d_g)));
  const long long rows_per_block = (n + slices - 1) / slices;
  slices = (n + rows_per_block - 1) / rows_per_block;
  const dim3 grid((unsigned)slices, (unsigned)groups);
  bin_counts_smem_kernel<<<grid, kThreads, smem, st>>>(
      (const int*)idx, (int*)out, n, r, d_g, log_g, d, rows_per_block);
  return (int)cudaGetLastError();
}
