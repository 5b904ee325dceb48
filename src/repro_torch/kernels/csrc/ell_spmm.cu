// ELL sparse products of the SC_RB eigensolver for Hopper:
//   z_matmul   y = diag(s) * Z * V    (gather,  (N, K))
//   zt_matmul  q = Z^T * diag(s) * u  (scatter, (D, K))
// where Z is the RB feature matrix in ELL form, idx int32 (N, R), one
// structural 1 per (row, grid).
//
// Replaces: src/repro/kernels/ell_spmm.py, z_matmul_pallas
// (_z_matmul_kernel) and zt_matmul_pallas (_zt_matmul_kernel). The TPU
// kernels turn the gather and the scatter into one-hot products on the
// MXU; the fused gram_matmul_pallas (_gram_matmul_kernel) is replaced by
// the zt kernel followed by the z kernel (ops.gram_matmul).
//
// What bounds them on the card: bytes, in two places. Each product reads
// idx (or its column-sorted copy) once: N*R*4 = 595 MB at the main path's
// N = 581,012, R = 256, 0.18 ms at 3.35 TB/s, for only N*R*K multiply-adds.
// The gathered rows of V (or of u) come from L2 as long as the operand fits
// there (u: 25.6 MB at K = 11), so in practice the rate of L2 sector
// gathers sets the pace: N*R gathers of a K-wide row.
//
// z_matmul design: one thread per (row, k); the K threads of a row read the
// same idx entries (served as one broadcast) and neighbouring k of one
// gathered V row, so a warp's gathers coalesce into whole V rows. Each
// thread sums its R terms in order, in float32, and scales once.
//
// zt_matmul design: a scatter-add with float atomics would sum in a
// different order on every run, and the fit's labels would follow. So the
// wrapper builds, once per fit, a column-sorted (CSC) copy of the fixed
// pattern (ops.ell_csc): the row id of every nonzero, stably sorted by
// column, and a (D+1) column pointer bounding each column. Then, per call:
//   1. zt_prescale: su[i] = s[i] * u[i], one (N, Kp) float32 row per row,
//      Kp = K rounded up to 4 (16-byte rows, zero pad): the same
//      single-rounded products as before, and no s gather later.
//   2. zt_main: one warp per column. L = (Kp/4 rounded up to a power of
//      two, at most 32) lanes share a nonzero, each lane gathering one
//      float4 of its padded row, and 32/L nonzeros go per warp step; each
//      lane sums in order and a fixed shuffle tree adds the slots, so the
//      result is the same bits on every run. A column of at most `chunk`
//      nonzeros (nearly all of them) is written straight to q. Columns
//      longer than that (a bin of a coarse grid can hold most of the N
//      rows) are skipped there; extra warps of the same launch reduce their
//      chunks of `chunk` nonzeros into a partial buffer.
//   3. zt_combine, only when long columns exist: one thread per (long
//      column, k) adds its chunk sums in order.
// K > 4*32 loops over groups of 128 columns. No atomic anywhere. The rate
// of L2 sector gathers bounds it: two 32-byte sectors per nonzero at K = 11.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
z_matmul_kernel(const int32_t* __restrict__ idx, const T* __restrict__ v,
                const float* __restrict__ s, T* __restrict__ out, int n, int r,
                int k) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long long)n * k) return;
  const long long i = gid / k;
  const int kk = (int)(gid - i * k);
  const int32_t* row = idx + i * r;
  float acc = 0.f;
#pragma unroll 8
  for (int g = 0; g < r; ++g) acc += to_float(v[(size_t)row[g] * k + kk]);
  store(out + gid, acc * s[i]);
}

__device__ __forceinline__ void add4(float4& a, const float4& v) {
  a.x += v.x;
  a.y += v.y;
  a.z += v.z;
  a.w += v.w;
}

// zt, step 1: su[i] = s[i] * u[i], padded to kp columns with 0.
__global__ void __launch_bounds__(kThreads)
zt_prescale_kernel(const float* __restrict__ u, const float* __restrict__ s,
                   float* __restrict__ su, int n, int k, int kp) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long long)n * kp) return;
  const long long i = gid / kp;
  const int j = (int)(gid - i * kp);
  su[gid] = j < k ? __fmul_rn(s[i], u[i * k + j]) : 0.f;
}

// zt, step 2: warps [0, d) take one column each and write q, skipping the
// long columns; warps [d, d + n_chunks) take one chunk of a long column
// each and write its partial sums. L lanes share a nonzero.
template <int L>
__global__ void __launch_bounds__(kThreads)
zt_main_kernel(const int32_t* __restrict__ rows,
               const int64_t* __restrict__ colptr,
               const int32_t* __restrict__ long_cols,
               const int64_t* __restrict__ long_chunk_ptr,
               const int32_t* __restrict__ chunk_long,
               const float4* __restrict__ su, float* __restrict__ q,
               float* __restrict__ partial, int d, long long n_chunks, int k,
               int kp, int chunk) {
  constexpr int kSlots = 32 / L;
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= d + n_chunks) return;  // whole warps leave together
  long long p0, p1;
  float* out;
  if (w < d) {
    p0 = colptr[w];
    p1 = colptr[w + 1];
    if (p1 - p0 > chunk) return;  // a long column: its chunks' warps
    out = q + w * k;
  } else {
    const long long c = w - d;
    const int li = chunk_long[c];
    const int col = long_cols[li];
    p0 = colptr[col] + (c - long_chunk_ptr[li]) * chunk;
    p1 = min(p0 + chunk, (long long)colptr[col + 1]);
    out = partial + c * k;
  }
  const int slot = lane / L, sub = lane % L;
  const int groups = kp / 4;  // float4 groups of a padded row
  for (int g0 = 0; g0 < groups; g0 += L) {
    const int g = g0 + sub;
    const bool active = g < groups;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    long long p = p0 + slot;
    for (; p + 3 * kSlots < p1; p += 4 * kSlots) {
      const int32_t r0 = rows[p], r1 = rows[p + kSlots];
      const int32_t r2 = rows[p + 2 * kSlots], r3 = rows[p + 3 * kSlots];
      if (active) {
        const float4 v0 = su[(long long)r0 * groups + g];
        const float4 v1 = su[(long long)r1 * groups + g];
        const float4 v2 = su[(long long)r2 * groups + g];
        const float4 v3 = su[(long long)r3 * groups + g];
        add4(acc, v0);
        add4(acc, v1);
        add4(acc, v2);
        add4(acc, v3);
      }
    }
    for (; p < p1; p += kSlots)
      if (active) add4(acc, su[(long long)rows[p] * groups + g]);
#pragma unroll
    for (int off = 16; off >= L; off >>= 1) {
      acc.x += __shfl_down_sync(0xffffffffu, acc.x, off);
      acc.y += __shfl_down_sync(0xffffffffu, acc.y, off);
      acc.z += __shfl_down_sync(0xffffffffu, acc.z, off);
      acc.w += __shfl_down_sync(0xffffffffu, acc.w, off);
    }
    if (slot == 0 && active) {  // the pad columns k..kp-1 are not stored
      float* o = out + 4 * g;
      o[0] = acc.x;
      if (4 * g + 1 < k) o[1] = acc.y;
      if (4 * g + 2 < k) o[2] = acc.z;
      if (4 * g + 3 < k) o[3] = acc.w;
    }
  }
}

// zt, step 3: one thread per (long column, k) adds its chunk sums in order.
__global__ void __launch_bounds__(kThreads)
zt_combine_kernel(const int32_t* __restrict__ long_cols,
                  const int64_t* __restrict__ long_chunk_ptr,
                  const float* __restrict__ partial, float* __restrict__ q,
                  int n_long, int k) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long long)n_long * k) return;
  const int li = (int)(gid / k);
  const int kk = (int)(gid - (long long)li * k);
  float acc = 0.f;
  for (long long c = long_chunk_ptr[li]; c < long_chunk_ptr[li + 1]; ++c)
    acc += partial[c * k + kk];
  q[(long long)long_cols[li] * k + kk] = acc;
}

template <int L>
void launch_zt_main(const void* rows, const void* colptr,
                    const void* long_cols, const void* long_chunk_ptr,
                    const void* chunk_long, const void* su, void* q,
                    void* partial, int d, long long n_chunks, int k, int kp,
                    int chunk, cudaStream_t stream) {
  const long long threads = ((long long)d + n_chunks) * 32;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  zt_main_kernel<L><<<blocks, kThreads, 0, stream>>>(
      (const int32_t*)rows, (const int64_t*)colptr,
      (const int32_t*)long_cols, (const int64_t*)long_chunk_ptr,
      (const int32_t*)chunk_long, (const float4*)su, (float*)q,
      (float*)partial, d, n_chunks, k, kp, chunk);
}

}  // namespace

extern "C" int z_matmul_launch(const void* idx, const void* v, const void* s,
                               void* out, int n, int r, int k, int v_is_bf16,
                               void* stream) {
  const long long total = (long long)n * k;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  if (v_is_bf16) {
    z_matmul_kernel<__nv_bfloat16><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)idx, (const __nv_bfloat16*)v, (const float*)s,
        (__nv_bfloat16*)out, n, r, k);
  } else {
    z_matmul_kernel<float><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)idx, (const float*)v, (const float*)s, (float*)out, n,
        r, k);
  }
  return (int)cudaGetLastError();
}

// q (d, k) from u (n, k) and s (n,) through the CSC tables of ops.ell_csc;
// su (n, kp) and partial (n_chunks, k) are scratch. kp is k rounded up to
// a multiple of 4.
extern "C" int zt_matmul_launch(const void* rows, const void* colptr,
                                const void* long_cols,
                                const void* long_chunk_ptr,
                                const void* chunk_long, const void* u,
                                const void* s, void* su, void* partial,
                                void* q, int n, int d, int k, int kp,
                                int n_long, long long n_chunks, int chunk,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long total = (long long)n * kp;
  if (total > 0) {
    const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
    zt_prescale_kernel<<<blocks, kThreads, 0, st>>>(
        (const float*)u, (const float*)s, (float*)su, n, k, kp);
  }
  // L lanes per nonzero: the float4 groups of a padded row, rounded up to a
  // power of two, at most 32
  const int groups = kp / 4;
  if (groups <= 1)
    launch_zt_main<1>(rows, colptr, long_cols, long_chunk_ptr, chunk_long,
                      su, q, partial, d, n_chunks, k, kp, chunk, st);
  else if (groups <= 2)
    launch_zt_main<2>(rows, colptr, long_cols, long_chunk_ptr, chunk_long,
                      su, q, partial, d, n_chunks, k, kp, chunk, st);
  else if (groups <= 4)
    launch_zt_main<4>(rows, colptr, long_cols, long_chunk_ptr, chunk_long,
                      su, q, partial, d, n_chunks, k, kp, chunk, st);
  else if (groups <= 8)
    launch_zt_main<8>(rows, colptr, long_cols, long_chunk_ptr, chunk_long,
                      su, q, partial, d, n_chunks, k, kp, chunk, st);
  else if (groups <= 16)
    launch_zt_main<16>(rows, colptr, long_cols, long_chunk_ptr, chunk_long,
                       su, q, partial, d, n_chunks, k, kp, chunk, st);
  else
    launch_zt_main<32>(rows, colptr, long_cols, long_chunk_ptr, chunk_long,
                       su, q, partial, d, n_chunks, k, kp, chunk, st);
  if (n_long > 0) {
    const long long t = (long long)n_long * k;
    const unsigned blocks = (unsigned)((t + kThreads - 1) / kThreads);
    zt_combine_kernel<<<blocks, kThreads, 0, st>>>(
        (const int32_t*)long_cols, (const int64_t*)long_chunk_ptr,
        (const float*)partial, (float*)q, n_long, k);
  }
  return (int)cudaGetLastError();
}
