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
// What bounds them on the card: bytes. Each product reads idx once
// (N*R*4 = 595 MB at the main path's N = 581,012, R = 256) and does only
// N*R*K multiply-adds; the gathered rows of V (or of u) come from L2 as
// long as the (D, K) operand fits there.
//
// z_matmul design: one thread per (row, k); the K threads of a row read the
// same idx entries (served as one broadcast) and neighbouring k of one
// gathered V row, so a warp's gathers coalesce into whole V rows. Each
// thread sums its R terms in order, in float32, and scales once.
//
// zt_matmul design: a scatter-add with float atomics would sum in a
// different order on every run, and the fit's labels would follow. So the
// wrapper builds, once per fit, a column-sorted (CSC) copy of the fixed
// pattern: the row id of every nonzero, stably sorted by column, a (D+1)
// column pointer, and a cut of every column's segment into chunks of at
// most `chunk` nonzeros (RB columns are very uneven: one bin of a coarse
// grid can hold most of the N rows). Pass 1: one warp reduces one chunk —
// lane l takes entries l, l+32, ..., keeps up to 32 of the K sums in
// registers, and the warp adds its lanes in a fixed shuffle tree. Pass 2:
// one thread per (column, k) adds the column's chunk sums in order. The
// order of every sum is fixed, so the result is the same bits on every
// run, and there is no atomic anywhere.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxKChunk = 32;  // zt: K values each lane keeps in registers

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

// zt, pass 1: one warp per chunk of at most `chunk` nonzeros of one column.
// Columns of very different occupancy (one bin of a coarse grid may hold
// most rows) are split into equal chunks, so no warp walks a whole heavy
// column alone.
__global__ void __launch_bounds__(kThreads)
zt_partial_kernel(const int32_t* __restrict__ rows,
                  const int64_t* __restrict__ colptr,
                  const int64_t* __restrict__ chunk_ptr,
                  const int32_t* __restrict__ chunk_col,
                  const float* __restrict__ u, const float* __restrict__ s,
                  float* __restrict__ partial, long long n_chunks, int k,
                  int chunk) {
  const long long c = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (c >= n_chunks) return;  // whole warps leave together
  const int col = chunk_col[c];
  const long long p0 = colptr[col] + (c - chunk_ptr[col]) * chunk;
  const long long p1 = min(p0 + chunk, (long long)colptr[col + 1]);
  for (int k0 = 0; k0 < k; k0 += kMaxKChunk) {
    const int kc = min(kMaxKChunk, k - k0);
    float acc[kMaxKChunk];
#pragma unroll
    for (int j = 0; j < kMaxKChunk; ++j) acc[j] = 0.f;
    for (long long p = p0 + lane; p < p1; p += 32) {
      const int32_t row = rows[p];
      const float sv = s[row];
      const float* ur = u + (size_t)row * k + k0;
#pragma unroll
      for (int j = 0; j < kMaxKChunk; ++j)
        if (j < kc) acc[j] += __fmul_rn(sv, ur[j]);
    }
#pragma unroll
    for (int j = 0; j < kMaxKChunk; ++j) {
      if (j < kc) {
        float v = acc[j];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_down_sync(0xffffffffu, v, off);
        if (lane == 0) partial[c * k + k0 + j] = v;
      }
    }
  }
}

// zt, pass 2: one thread per (column, k) adds its column's chunk sums in
// chunk order. An empty column has no chunks and gets 0.
__global__ void __launch_bounds__(kThreads)
zt_combine_kernel(const int64_t* __restrict__ chunk_ptr,
                  const float* __restrict__ partial, float* __restrict__ q,
                  int d, int k) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long long)d * k) return;
  const long long col = gid / k;
  const int kk = (int)(gid - col * k);
  float acc = 0.f;
  for (long long c = chunk_ptr[col]; c < chunk_ptr[col + 1]; ++c)
    acc += partial[c * k + kk];
  q[gid] = acc;
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

extern "C" int zt_matmul_launch(const void* rows, const void* colptr,
                                const void* chunk_ptr, const void* chunk_col,
                                const void* u, const void* s, void* partial,
                                void* q, long long n_chunks, int d, int k,
                                int chunk, void* stream) {
  if (n_chunks > 0) {
    const long long threads = n_chunks * 32;
    const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
    zt_partial_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)rows, (const int64_t*)colptr,
        (const int64_t*)chunk_ptr, (const int32_t*)chunk_col,
        (const float*)u, (const float*)s, (float*)partial, n_chunks, k,
        chunk);
  }
  const long long total = (long long)d * k;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  zt_combine_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)chunk_ptr, (const float*)partial, (float*)q, d, k);
  return (int)cudaGetLastError();
}
