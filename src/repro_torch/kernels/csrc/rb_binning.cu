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
// It must agree bit for bit with the plain version, whose quotient is the
// IEEE one: one ulp in the division flips a bin.
//
// What bounds it on the card: operations. At the main path's shape
// (N = 581,012, R = 256, d = 54) it does N*R*d = 8.0e9 (row, grid, dim)
// steps and moves only x (125 MB) and idx (595 MB). Done plainly, each
// step spends three instructions of the MUFU/conversion pipes (16 lanes a
// clock an SM, against 128 for FP32): the IEEE divide, floorf and the
// float -> int conversion.
//
// Design: no divide, floor or conversion per step.
//   1. rb_consts, once per (grid, dim): c_lo <= (1/w)(1 - 2^-22) and
//      c_hi >= (1/w)(1 + 2^-22), computed in double and rounded outward.
//   2. rb_binning_kernel, per step: t = x - b, then
//        ya = fma_rd(t, c_hi, 1.5*2^23),  yb = fma_rd(t, c_lo, 1.5*2^23).
//      For |t*c| < 2^22 the rounded-down sum lies in [2^23, 2^24), where
//      floats are the integers, so ya = floor(t*c_hi) + 1.5*2^23 exactly
//      and its bits are floor(t*c_hi) + 0x4B400000. The IEEE quotient
//      q = RN(t/w) lies between t*c_lo and t*c_hi (its relative error is at
//      most 2^-24 < 2^-22), so when ya == yb, both in that binade, floor(q)
//      is theirs. The hash takes ya's bits directly: sum_j bits_j * a_j,
//      less 0x4B400000 * sum_j a_j at the end. A step is one FADD, two
//      FFMA.RM, two LOP3 (the OR of ya ^ yb; the OR of ya ^ 0x4B400000,
//      whose sign and exponent bits stay 0 while ya is in the binade; yb is
//      then too, or ya ^ yb is not 0) and one IMAD, all on the FP32/INT
//      pipes.
//   3. A (row, grid) where some step had ya != yb (an integer lies within
//      2^-22 of the quotient: about 1e-5 of the steps) or left the binade
//      (|q| >= 2^22, or x non-finite) is hashed again by exact_hash:
//      today's IEEE sequence (__fdiv_rn, floorf, the cast) over all its
//      dims, from device memory. So are the rows with an x of magnitude in
//      (0, 2^-100) and the grids with a bias of magnitude in (0, 2^-100) or
//      a width outside (0, 2^20) (c = inf fails every step): outside them
//      t is 0 or |t/w| > 2^-143, so q is not flushed to 0 and keeps t's
//      sign, which settles floor(q) for |q| < 1. So the result is the same
//      bits as the plain version on every row.
// Layout: one thread per (row, grid). A block covers 32 grids (threadIdx.x,
// so a warp writes 32 consecutive int32 of one idx row) and 64 rows (8
// thread rows, 8 rows per thread). The block stages its grids' constants
// and its rows of x in shared memory, 32 dims at a time; each thread reads
// four dims of a row (x) or of its grid (each constant) with one 16-byte
// load. The hash is a sum mod 2^32, so chunks of dims add up to one pass.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGridTile = 32;      // grids per block (threadIdx.x)
constexpr int kThreadRows = 8;     // threadIdx.y
constexpr int kRowsPerThread = 8;  // rows each thread hashes
constexpr int kRowsPerBlock = kThreadRows * kRowsPerThread;
constexpr int kDimChunk = 32;      // dimensions staged per pass
constexpr int kXStride = kDimChunk + 4;  // 16-byte rows, no bank pattern
constexpr uint32_t kHashMix = 2654435769u;
constexpr float kMagic = 12582912.0f;    // 1.5 * 2^23
constexpr uint32_t kMagicBits = 0x4B400000u;
constexpr uint32_t kExpMask = 0xFF800000u;     // sign and exponent
constexpr float kTiny = 0x1p-100f;             // see rb_consts_kernel

__global__ void rb_consts_kernel(const float* __restrict__ w,
                                 const float* __restrict__ b,
                                 float2* __restrict__ consts, int total) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const double wd = (double)w[e];
  const double inv = 1.0 / wd;
  const double margin = 0x1p-22;
  float2 c = make_float2(__double2float_rd(inv * (1.0 - margin)),
                         __double2float_ru(inv * (1.0 + margin)));
  // a width outside (0, 2^20), or a bias that is tiny but not 0, sends the
  // grid's rows to exact_hash: c = inf makes every step's ya non-finite
  const float bv = fabsf(b[e]);
  if (!(wd > 0.0 && wd < 0x1p20) || (bv > 0.f && bv < kTiny))
    c = make_float2(INFINITY, INFINITY);
  consts[e] = c;
}

// The exact sequence for one (row, grid): the hash before c and the mix.
__device__ __noinline__ uint32_t exact_hash(const float* __restrict__ xr,
                                            const float* __restrict__ wg,
                                            const float* __restrict__ bg,
                                            const uint32_t* __restrict__ ag,
                                            int d) {
  uint32_t h = 0u;
  for (int j = 0; j < d; ++j) {
    const float bin = floorf(__fdiv_rn(xr[j] - bg[j], wg[j]));
    h += (uint32_t)(int32_t)bin * ag[j];
  }
  return h;
}

__global__ void __launch_bounds__(kGridTile * kThreadRows, 3)
rb_binning_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, const uint32_t* __restrict__ a,
                  const uint32_t* __restrict__ c,
                  const float2* __restrict__ consts, int32_t* __restrict__ out,
                  int n, int d, int r, int d_g, int shift) {
  // [dim / 4][grid]: lane g reads 16 consecutive bytes, no bank conflict
  __shared__ float4 clo_s[kDimChunk / 4][kGridTile];
  __shared__ float4 chi_s[kDimChunk / 4][kGridTile];
  __shared__ float4 b_s[kDimChunk / 4][kGridTile];
  __shared__ uint4 a_s[kDimChunk / 4][kGridTile];
  __shared__ __align__(16) float x_s[kRowsPerBlock][kXStride];
  __shared__ uint32_t row_bad[kRowsPerBlock];  // a tiny nonzero x

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kGridTile + tx;
  const int nthreads = kGridTile * kThreadRows;
  const int g0 = blockIdx.y * kGridTile;
  const int g = g0 + tx;
  const long long row0 = (long long)blockIdx.x * kRowsPerBlock;

  // per row: the hash, the OR of ya ^ yb, and the OR of ya ^ 0x4B400000
  // (its sign and exponent bits stay 0 while every ya is in [2^23, 2^24))
  uint32_t h[kRowsPerThread], bad[kRowsPerThread], out_of[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) h[i] = bad[i] = out_of[i] = 0u;
  uint32_t a_sum = 0u;
  if (tid < kRowsPerBlock) row_bad[tid] = 0u;

  for (int d0 = 0; d0 < d; d0 += kDimChunk) {
    const int dc = min(kDimChunk, d - d0);
    __syncthreads();  // the previous chunk has been consumed
    // one thread a (grid, 4 dims): one 16-byte store to each array; dims
    // past dc (and grids past r) get the neutral step: t = 0 - (-1) = 1,
    // ya = yb = 1.5*2^23, a = 0, in range
    {
      static_assert(kGridTile * kDimChunk / 4 == kGridTile * kThreadRows,
                    "one (grid, 4 dims) per thread");
      const int gg = tid % kGridTile;
      const int qd = tid / kGridTile;
      const int gi = g0 + gg;
      float lo[4], hi[4], bb[4];
      uint32_t aa[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int dd = 4 * qd + j;
        lo[j] = hi[j] = 0.f;
        bb[j] = -1.f;
        aa[j] = 0u;
        if (gi < r && dd < dc) {
          const size_t off = (size_t)gi * d + d0 + dd;
          const float2 kv = consts[off];
          lo[j] = kv.x;
          hi[j] = kv.y;
          bb[j] = b[off];
          aa[j] = a[off];
        }
      }
      clo_s[qd][gg] = make_float4(lo[0], lo[1], lo[2], lo[3]);
      chi_s[qd][gg] = make_float4(hi[0], hi[1], hi[2], hi[3]);
      b_s[qd][gg] = make_float4(bb[0], bb[1], bb[2], bb[3]);
      a_s[qd][gg] = make_uint4(aa[0], aa[1], aa[2], aa[3]);
    }
    for (int e = tid; e < kRowsPerBlock * kDimChunk; e += nthreads) {
      const int rr = e / kDimChunk;
      const int dd = e % kDimChunk;
      const long long row = row0 + rr;
      const float xv =
          (row < n && dd < dc) ? x[(size_t)row * d + d0 + dd] : 0.f;
      x_s[rr][dd] = xv;
      if (xv != 0.f && fabsf(xv) < kTiny) row_bad[rr] = 1u;
    }
    __syncthreads();
    const int dq = (dc + 3) / 4;
    for (int q = 0; q < dq; ++q) {
      const float4 clo = clo_s[q][tx], chi = chi_s[q][tx];
      const float4 bv = b_s[q][tx];
      const uint4 av = a_s[q][tx];
      a_sum += av.x + av.y + av.z + av.w;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float4 xv =
            *reinterpret_cast<const float4*>(&x_s[ty + i * kThreadRows][4 * q]);
#define RB_STEP(X, B, CLO, CHI, A)                                           \
  {                                                                         \
    const uint32_t ya = __float_as_uint(__fmaf_rd(X - B, CHI, kMagic));     \
    const uint32_t yb = __float_as_uint(__fmaf_rd(X - B, CLO, kMagic));     \
    bad[i] |= ya ^ yb;                                                      \
    out_of[i] |= ya ^ kMagicBits;                                           \
    h[i] += ya * A;                                                         \
  }
        RB_STEP(xv.x, bv.x, clo.x, chi.x, av.x)
        RB_STEP(xv.y, bv.y, clo.y, chi.y, av.y)
        RB_STEP(xv.z, bv.z, clo.z, chi.z, av.z)
        RB_STEP(xv.w, bv.w, clo.w, chi.w, av.w)
#undef RB_STEP
      }
    }
  }
  if (g >= r) return;
  const uint32_t cg = c[g];
  const uint32_t bias = a_sum * kMagicBits;  // the 1.5*2^23 in every ya
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const long long row = row0 + ty + i * kThreadRows;
    if (row < n) {
      uint32_t hh = h[i] - bias;
      if (bad[i] | (out_of[i] & kExpMask) | row_bad[ty + i * kThreadRows])
        hh = exact_hash(x + (size_t)row * d, w + (size_t)g * d,
                        b + (size_t)g * d, a + (size_t)g * d, d);
      hh = (hh + cg) * kHashMix;
      const int32_t local = shift >= 32 ? 0 : (int32_t)(hh >> shift);
      out[(size_t)row * r + g] = local + g * d_g;
    }
  }
}

}  // namespace

// consts: (r, d) float2 scratch for the per (grid, dim) constants.
extern "C" int rb_binning_launch(const void* x, const void* w, const void* b,
                                 const void* a, const void* c, void* consts,
                                 void* out, int n, int d, int r, int d_g,
                                 void* stream) {
  int bits = 0;
  while ((1 << bits) < d_g) ++bits;          // d_g is a power of two
  const int shift = 32 - bits;               // = 32 - bit_length(d_g) + 1
  cudaStream_t st = (cudaStream_t)stream;
  const int total = r * d;
  rb_consts_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      (const float*)w, (const float*)b, (float2*)consts, total);
  const dim3 block(kGridTile, kThreadRows);
  const dim3 grid((unsigned)((n + kRowsPerBlock - 1) / kRowsPerBlock),
                  (unsigned)((r + kGridTile - 1) / kGridTile));
  rb_binning_kernel<<<grid, block, 0, st>>>(
      (const float*)x, (const float*)w, (const float*)b, (const uint32_t*)a,
      (const uint32_t*)c, (const float2*)consts, (int32_t*)out, n, d, r, d_g,
      shift);
  return (int)cudaGetLastError();
}
