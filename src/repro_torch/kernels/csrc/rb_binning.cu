// Hashed Random Binning features (the paper's Algorithm 1) for Hopper.
//
// Replaces: src/repro/kernels/rb_binning.py, rb_binning_pallas
// (_rb_binning_kernel), the TPU kernel that maps each point to one hashed
// bin per random grid.
//
// What it computes, for every (row i, grid g):
//   bin_j = (uint32)(int32) floor((x[i,j] - b[g,j]) / w[g,j])
//   h     = ((sum_j bin_j * a[g,j] + c[g]) * HASH_MIX)  mod 2^32
//   idx[i,g] = (h >> (32 - log2 d_g)) + g * d_g
// It must agree bit for bit with the plain version: one ulp in the
// division flips a bin. So the division is IEEE (__fdiv_rn; the library is
// built without --use_fast_math), the floor is floorf, and the hash uses
// wrapping uint32 arithmetic.
//
// What bounds it on the card: operations. At the main path's shape
// (N = 581,012, R = 256, d = 54) it does N*R*d = 8.0e9 subtract/divide/
// floor/multiply-add steps, while it moves only x (125 MB) and idx
// (595 MB). An IEEE division is a multi-instruction sequence, so the
// divide throughput sets the time.
//
// Design: one thread per (row, grid). A block covers 32 grids (threadIdx.x,
// so a warp writes 32 consecutive int32 of one idx row) and 64 rows (8
// thread rows, 8 rows per thread). The block stages its grids' w, b, a and
// its rows of x in shared memory, 32 dimensions at a time, so each
// parameter is read from device memory once per 64 rows and each x value
// once per 32 grids. The hash is a sum mod 2^32, so summing it over
// dimension chunks gives the same bits as one pass.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGridTile = 32;      // grids per block (threadIdx.x)
constexpr int kThreadRows = 8;     // threadIdx.y
constexpr int kRowsPerThread = 8;  // rows each thread hashes
constexpr int kRowsPerBlock = kThreadRows * kRowsPerThread;
constexpr int kDimChunk = 32;      // dimensions staged per pass
constexpr uint32_t kHashMix = 2654435769u;

__global__ void __launch_bounds__(kGridTile * kThreadRows)
rb_binning_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, const uint32_t* __restrict__ a,
                  const uint32_t* __restrict__ c, int32_t* __restrict__ out,
                  int n, int d, int r, int d_g, int shift) {
  __shared__ float w_s[kDimChunk][kGridTile];
  __shared__ float b_s[kDimChunk][kGridTile];
  __shared__ uint32_t a_s[kDimChunk][kGridTile];
  __shared__ float x_s[kRowsPerBlock][kDimChunk + 1];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kGridTile + tx;
  const int nthreads = kGridTile * kThreadRows;
  const int g0 = blockIdx.y * kGridTile;
  const int g = g0 + tx;
  const long long row0 = (long long)blockIdx.x * kRowsPerBlock;

  uint32_t h[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) h[i] = 0u;

  for (int d0 = 0; d0 < d; d0 += kDimChunk) {
    const int dc = min(kDimChunk, d - d0);
    __syncthreads();  // the previous chunk has been consumed
    // consecutive threads read consecutive dimensions of one grid
    for (int e = tid; e < kGridTile * kDimChunk; e += nthreads) {
      const int gg = e / kDimChunk;
      const int dd = e % kDimChunk;
      const int gi = g0 + gg;
      if (gi < r && dd < dc) {
        const size_t off = (size_t)gi * d + d0 + dd;
        w_s[dd][gg] = w[off];
        b_s[dd][gg] = b[off];
        a_s[dd][gg] = a[off];
      }
    }
    for (int e = tid; e < kRowsPerBlock * kDimChunk; e += nthreads) {
      const int rr = e / kDimChunk;
      const int dd = e % kDimChunk;
      const long long row = row0 + rr;
      x_s[rr][dd] = (row < n && dd < dc) ? x[(size_t)row * d + d0 + dd] : 0.f;
    }
    __syncthreads();
    if (g < r) {
      for (int dd = 0; dd < dc; ++dd) {
        const float wv = w_s[dd][tx];
        const float bv = b_s[dd][tx];
        const uint32_t av = a_s[dd][tx];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const float t = x_s[ty + i * kThreadRows][dd] - bv;
          const float bin = floorf(__fdiv_rn(t, wv));
          h[i] += (uint32_t)(int32_t)bin * av;
        }
      }
    }
  }
  if (g >= r) return;
  const uint32_t cg = c[g];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const long long row = row0 + ty + i * kThreadRows;
    if (row < n) {
      const uint32_t hh = (h[i] + cg) * kHashMix;
      const int32_t local = shift >= 32 ? 0 : (int32_t)(hh >> shift);
      out[(size_t)row * r + g] = local + g * d_g;
    }
  }
}

}  // namespace

extern "C" int rb_binning_launch(const void* x, const void* w, const void* b,
                                 const void* a, const void* c, void* out,
                                 int n, int d, int r, int d_g, void* stream) {
  int bits = 0;
  while ((1 << bits) < d_g) ++bits;          // d_g is a power of two
  const int shift = 32 - bits;               // = 32 - bit_length(d_g) + 1
  const dim3 block(kGridTile, kThreadRows);
  const dim3 grid((unsigned)((n + kRowsPerBlock - 1) / kRowsPerBlock),
                  (unsigned)((r + kGridTile - 1) / kGridTile));
  rb_binning_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)b, (const uint32_t*)a,
      (const uint32_t*)c, (int32_t*)out, n, d, r, d_g, shift);
  return (int)cudaGetLastError();
}
