// Fused k-means assignment (distance + argmin) for Hopper.
//
// Replaces: src/repro/kernels/kmeans_assign.py, kmeans_assign_pallas
// (_kmeans_assign_kernel), the TPU kernel behind every Lloyd step of the
// fit and the last step of predict.
//
// What it computes, for every row i:
//   d2[k]     = |x_i|^2 - 2 x_i . c_k + |c_k|^2
//   labels[i] = argmin_k d2[k]   (first index on ties: strict <)
//   dist[i]   = max(min_k d2[k], 0)
// all in float32. No TF32 and no mma: the embedding is narrow (K = 7 on
// the main path), so the dot products are plain FMA loops.
//
// What bounds it on the card: bytes. It reads x once (N*d*4) and writes a
// label and a distance per row; the N*K*d multiply-adds are far below the
// card's float32 rate.
//
// Design: one thread per row. The block stages the (K, d) centroids and
// their squared norms in shared memory, where every thread of a warp reads
// the same element at once (a broadcast). The distances never leave
// registers: only the label and the distance are written.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     int32_t* __restrict__ labels, float* __restrict__ dist,
                     int n, int d, int k) {
  extern __shared__ float smem[];
  float* c_s = smem;           // (k, d)
  float* c2_s = smem + k * d;  // (k,)
  for (int e = threadIdx.x; e < k * d; e += blockDim.x) c_s[e] = c[e];
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    float acc = 0.f;
    for (int t = 0; t < d; ++t) acc += c_s[j * d + t] * c_s[j * d + t];
    c2_s[j] = acc;
  }
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* xr = x + i * d;
  float x2 = 0.f;
  for (int t = 0; t < d; ++t) x2 += xr[t] * xr[t];
  float best = 0.f;
  int best_k = 0;
  for (int j = 0; j < k; ++j) {
    float xc = 0.f;
    for (int t = 0; t < d; ++t) xc += xr[t] * c_s[j * d + t];
    const float d2 = x2 - 2.f * xc + c2_s[j];
    if (j == 0 || d2 < best) {
      best = d2;
      best_k = j;
    }
  }
  labels[i] = best_k;
  dist[i] = fmaxf(best, 0.f);
}

}  // namespace

extern "C" int kmeans_assign_launch(const void* x, const void* c, void* labels,
                                    void* dist, int n, int d, int k,
                                    void* stream) {
  const size_t smem = (size_t)(k * d + k) * sizeof(float);
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  kmeans_assign_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)c, (int32_t*)labels, (float*)dist, n, d,
      k);
  return (int)cudaGetLastError();
}
