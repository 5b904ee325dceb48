// Fused k-means assignment (distance + argmin) for Hopper, and its
// statistics form (the Lloyd step's counts and sums in the same pass).
//
// Replaces: src/repro/kernels/kmeans_assign.py, kmeans_assign_pallas
// (_kmeans_assign_kernel), the TPU kernel behind every Lloyd step of the
// fit and the last step of predict; and, with the statistics epilogue,
// src/repro/kernels/ops.py's kmeans_assign_stats (the assignment plus its
// two segment sums).
//
// What it computes, for every row i:
//   d2[k]     = |x_i|^2 - 2 x_i . c_k + |c_k|^2
//   labels[i] = argmin_k d2[k]   (first index on ties: strict <)
//   dist[i]   = max(min_k d2[k], 0)
// all in float32 with FMA. No TF32 and no mma: the embedding is narrow (d
// = K = 7 on the main path), so the dot products are plain FMA loops. The
// statistics form writes the labels and, instead of dist,
//   counts[j] = #{i : labels[i] = j},  sums[j] = sum_{labels[i] = j} x_i,
//   inertia   = sum_i dist[i].
//
// What bounds it on the card: bytes. It reads x once (N*d*4) and writes a
// label and a distance per row; the N*K*d multiply-adds are far below the
// card's float32 rate. At the fit's (581,012 x 7, 7 centroids) that is
// 20.9 MB, 6.2 us at 3.35 TB/s.
//
// Design:
//   - The kernel is a template on the width D (1..16; D = 0 is the looped
//     form for any wider row). A block of 256 threads walks tiles of
//     256*RPT contiguous rows; it copies a tile's N*D floats from device
//     memory with 16-byte loads into shared memory, rows at an odd stride
//     (D | 1 words), so that the 32 lanes of a warp, reading 32
//     neighbouring rows, meet 32 different banks. Each thread then holds
//     its rows in registers, fully unrolled over D.
//   - The (K, D) centroids and their norms sit in shared memory, loaded
//     and normed in parallel once a block; every lane of a warp reads the
//     same element at once (a broadcast).
//   - The grid is the card's resident blocks (occupancy x SMs) or fewer
//     when the rows need fewer tiles: a function of the shape and the card
//     alone.
//   - Statistics epilogue, with no float atomics: for every tile each warp
//     adds its rows' (label == j) terms (rows of a thread in order, then a
//     fixed reduce-scatter butterfly over the lanes: d + 1 values of a
//     cluster in kP - 1 + 5 - log2(kP) shuffles, kP = d + 1 rounded up to
//     a power of two, not 5 (d + 1)) into its own accumulators in shared
//     memory; at the end the block adds its warps in warp order and writes
//     one partial row. A two-level tree of ticket counters (atomicAdd on
//     an int behind __threadfence) adds the rows: the last block of each
//     group of 32 adds its group's rows in order into a group row, and the
//     last of those adds the group rows in order. (One block adding all
//     568 rows alone took ~17-27 us on the H100, a tail the rest of the
//     card idles through.) So the bits are the same on every run. The
//     counters and the partial rows live in the caller's scratch, whose
//     size kmeans_assign_stats_scratch gives; every launch zeroes the
//     counters on its stream first, so no state outlives a launch.
// The looped form (D = 0) reads each row from device memory, once per
// centroid.
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <mutex>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__host__ __device__ constexpr int pow2_ceil(int v) {
  return v <= 1 ? 1 : 2 * pow2_ceil((v + 1) / 2);
}
__host__ __device__ constexpr int ilog2(int v) {
  return v <= 1 ? 0 : 1 + ilog2(v >> 1);
}

template <int D>
struct Shape {
  static constexpr int kStride = D | 1;  // odd: no bank conflicts
  // rows a thread takes per tile: a tile's rows stay within 32 KB
  static constexpr int kRpt =
      D == 0 ? 1 : (32 / kStride < 1 ? 1 : (32 / kStride > 4 ? 4 : 32 / kStride));
  static constexpr int kRows = kThreads * kRpt;
  static constexpr int kTileFloats = D == 0 ? 0 : kRows * kStride;
};

struct Args {
  const float* x;
  const float* c;
  int32_t* labels;
  float* dist;      // assignment form only
  float* partial;   // statistics form: (grid + groups, e_pad) scratch
  float* counts;    // (k,)
  float* sums;      // (k, d)
  float* inertia;   // ()
  unsigned int* ticket;  // 1 + groups counters, 0 at the launch
  int n, d, k;
};

// Blocks whose partials the last of them adds (the first level of the
// statistics form's reduction tree).
constexpr int kGroup = 32;

// After the block's writes: true on every thread of the block that
// arrives last of `count` at *ticket (its writes and theirs visible).
__device__ __forceinline__ bool last_arrival(unsigned int* ticket,
                                             int count) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == (unsigned)count - 1u;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// emit(e, sum of rows[r * e_pad + e] over r < n_rows) for e < e_pad, in a
// fixed order: q = kThreads / e_pad groups of threads each add a run of
// the rows in order (loads in flight), then the q sums add in order.
template <typename Emit>
__device__ __forceinline__ void add_rows(const float* rows, int n_rows,
                                         int e_pad, Emit emit) {
  __shared__ float red[kThreads];
  const int tid = threadIdx.x;
  const int q = max(1, min(kThreads / e_pad, n_rows));
  if (q == 1) {
    for (int e = tid; e < e_pad; e += kThreads) {
      float s = 0.f;
      for (int r = 0; r < n_rows; ++r) s += __ldcg(rows + (size_t)r * e_pad + e);
      emit(e, s);
    }
    return;
  }
  if (tid < q * e_pad) {
    const int part = tid / e_pad, e = tid - part * e_pad;
    const int r0 = part * n_rows / q, r1 = (part + 1) * n_rows / q;
    float s = 0.f;
#pragma unroll 8
    for (int r = r0; r < r1; ++r) s += __ldcg(rows + (size_t)r * e_pad + e);
    red[tid] = s;
  }
  __syncthreads();
  if (tid < e_pad) {
    float s = 0.f;
    for (int part = 0; part < q; ++part) s += red[part * e_pad + tid];
    emit(tid, s);
  }
}

template <int D, bool STATS>
__global__ void __launch_bounds__(kThreads)
kmeans_assign_kernel(Args a) {
  using S = Shape<D>;
  const int d = D > 0 ? D : a.d;
  const int k = a.k;
  const int e_len = k * (d + 1) + 1;  // per cluster d sums and a count; inertia
  extern __shared__ float smem[];
  float* tile = smem;                    // (kRows, kStride)
  float* c_s = smem + S::kTileFloats;    // (k, d)
  float* c2_s = c_s + k * d;             // (k,)
  float* acc_s = c2_s + k;               // (kWarps, e_len), statistics form
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int e = tid; e < k * d; e += kThreads) c_s[e] = a.c[e];
  if (STATS)
    for (int e = tid; e < kWarps * e_len; e += kThreads) acc_s[e] = 0.f;
  __syncthreads();
  // one warp a centroid norm, lanes over the width, a fixed tree
  for (int j = warp; j < k; j += kWarps) {
    float s = 0.f;
    for (int t = lane; t < d; t += 32) s += c_s[j * d + t] * c_s[j * d + t];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) c2_s[j] = s;
  }

  const int n_tiles = (a.n + S::kRows - 1) / S::kRows;
  for (int ti = blockIdx.x; ti < n_tiles; ti += gridDim.x) {
    const long long row0 = (long long)ti * S::kRows;
    const int rows = (int)min((long long)S::kRows, a.n - row0);
    __syncthreads();  // the previous tile is read; the norms are written
    if constexpr (D > 0) {
      // the tile's rows*D floats: 16-byte loads where aligned
      const float* base = a.x + row0 * D;
      const int cnt = rows * D;
      int head = (int)(((16u - ((uintptr_t)base & 15u)) & 15u) >> 2);
      head = min(head, cnt);
      const int n4 = (cnt - head) >> 2;
      auto put = [&](int e, float v) {
        tile[(e / D) * S::kStride + e % D] = v;
      };
      for (int e = tid; e < head; e += kThreads) put(e, base[e]);
      const float4* b4 = reinterpret_cast<const float4*>(base + head);
      for (int i = tid; i < n4; i += kThreads) {
        const float4 v = b4[i];
        const int e = head + 4 * i;
        put(e, v.x);
        put(e + 1, v.y);
        put(e + 2, v.z);
        put(e + 3, v.w);
      }
      for (int e = head + 4 * n4 + tid; e < cnt; e += kThreads)
        put(e, base[e]);
      __syncthreads();
    }
    int lab[S::kRpt];
    float best[S::kRpt];
#pragma unroll
    for (int rr = 0; rr < S::kRpt; ++rr) {
      const int lr = rr * kThreads + tid;
      lab[rr] = -1;  // no row
      best[rr] = 0.f;
      if (lr >= rows) continue;
      const long long i = row0 + lr;
      float bd = 0.f;
      int bk = 0;
      if constexpr (D > 0) {
        float xv[D];
#pragma unroll
        for (int t = 0; t < D; ++t) xv[t] = tile[lr * S::kStride + t];
        float x2 = 0.f;
#pragma unroll
        for (int t = 0; t < D; ++t) x2 += xv[t] * xv[t];
        for (int j = 0; j < k; ++j) {
          float xc = 0.f;
#pragma unroll
          for (int t = 0; t < D; ++t) xc += xv[t] * c_s[j * D + t];
          const float d2 = x2 - 2.f * xc + c2_s[j];
          if (j == 0 || d2 < bd) {
            bd = d2;
            bk = j;
          }
        }
      } else {
        const float* xr = a.x + i * d;
        float x2 = 0.f;
        for (int t = 0; t < d; ++t) x2 += xr[t] * xr[t];
        for (int j = 0; j < k; ++j) {
          float xc = 0.f;
          for (int t = 0; t < d; ++t) xc += xr[t] * c_s[j * d + t];
          const float d2 = x2 - 2.f * xc + c2_s[j];
          if (j == 0 || d2 < bd) {
            bd = d2;
            bk = j;
          }
        }
      }
      lab[rr] = bk;
      best[rr] = fmaxf(bd, 0.f);
      a.labels[i] = bk;
      if (!STATS) a.dist[i] = best[rr];
    }
    if constexpr (STATS) {
      // this tile's terms: a thread's rows in order, then the lanes by a
      // fixed tree; lane 0 adds them to the warp's accumulators
      auto warp_add = [&](int e, float v) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) acc_s[warp * e_len + e] += v;
      };
      if constexpr (D > 0) {
        // per cluster the D + 1 values (sums, count), padded to kP, by a
        // reduce-scatter butterfly: at lane bit 16, 8, ... each lane keeps
        // half of its values and adds its partner's of that half, so
        // kP - 1 shuffles leave value lane >> (5 - kLog) on each lane,
        // summed over 2^kLog lanes; the low lane bits then add as a tree
        constexpr int kP = pow2_ceil(D + 1);
        constexpr int kLog = ilog2(kP);
        for (int j = 0; j < k; ++j) {
          float v[kP];
#pragma unroll
          for (int t = 0; t < kP; ++t) v[t] = 0.f;
#pragma unroll
          for (int rr = 0; rr < S::kRpt; ++rr) {
            if (lab[rr] != j) continue;
            const float* xr = tile + (rr * kThreads + tid) * S::kStride;
#pragma unroll
            for (int t = 0; t < D; ++t) v[t] += xr[t];
            v[D] += 1.f;
          }
#pragma unroll
          for (int step = 0; step < kLog; ++step) {
            const int h = kP >> (step + 1), bit = 16 >> step;
            const bool upper = (lane & bit) != 0;
#pragma unroll
            for (int i = 0; i < h; ++i) {
              const float send = upper ? v[i] : v[i + h];
              const float keep = upper ? v[i + h] : v[i];
              v[i] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
            }
          }
          float r = v[0];
#pragma unroll
          for (int bit = 16 >> kLog; bit > 0; bit >>= 1)
            r += __shfl_xor_sync(0xffffffffu, r, bit);
          const int idx = lane >> (5 - kLog);
          if ((lane & ((32 >> kLog) - 1)) == 0 && idx <= D)
            acc_s[warp * e_len + j * (D + 1) + idx] += r;
        }
      } else {
        for (int j = 0; j < k; ++j) {
          warp_add(j * (d + 1) + d, lab[0] == j ? 1.f : 0.f);
          for (int t = 0; t < d; ++t) {
            float s = 0.f;
            if (lab[0] == j) s = a.x[(row0 + tid) * d + t];
            warp_add(j * (d + 1) + t, s);
          }
        }
      }
      float in = 0.f;
#pragma unroll
      for (int rr = 0; rr < S::kRpt; ++rr) in += best[rr];
      warp_add(e_len - 1, in);
    }
  }
  if constexpr (STATS) {
    __syncthreads();
    // the block's partial, its warps in warp order: row blockIdx.x of
    // part1 (rows of e_pad floats, whole 32-byte sectors, zero pad)
    const int e_pad = (e_len + 7) & ~7;
    const int g = gridDim.x;
    const int n_groups = (g + kGroup - 1) / kGroup;
    float* part1 = a.partial;                       // (g, e_pad)
    float* part2 = a.partial + (size_t)g * e_pad;   // (n_groups, e_pad)
    for (int e = tid; e < e_pad; e += kThreads) {
      float s = 0.f;
      if (e < e_len)
        for (int w = 0; w < kWarps; ++w) s += acc_s[w * e_len + e];
      part1[(size_t)blockIdx.x * e_pad + e] = s;
    }
    // the last block of each group of kGroup blocks adds the group's rows
    // into a row of part2, and the last of those adds part2's rows
    const int grp = blockIdx.x / kGroup;
    const int in_grp = min(kGroup, g - grp * kGroup);
    if (!last_arrival(a.ticket + 1 + grp, in_grp)) return;
    add_rows(part1 + (size_t)grp * kGroup * e_pad, in_grp, e_pad,
             [&](int e, float v) { part2[(size_t)grp * e_pad + e] = v; });
    if (!last_arrival(a.ticket, n_groups)) return;
    add_rows(part2, n_groups, e_pad, [&](int e, float v) {
      if (e == e_len - 1) {
        *a.inertia = v;
      } else if (e < e_len - 1) {
        const int j = e / (d + 1), t = e - j * (d + 1);
        if (t == d)
          a.counts[j] = v;
        else
          a.sums[j * d + t] = v;
      }
    });
  }
}

template <int D>
size_t smem_bytes(int d, int k, bool stats) {
  const int e_len = k * (d + 1) + 1;
  return sizeof(float) * ((size_t)Shape<D>::kTileFloats + (size_t)k * d + k +
                          (stats ? (size_t)kWarps * e_len : 0));
}

// The grid for n rows: the card's resident blocks, or fewer if the tiles
// are fewer. Fails if a block's shared memory does not fit.
template <int D, bool STATS>
cudaError_t plan(int n, int d, int k, int& blocks, size_t& smem) {
  auto kernel = kmeans_assign_kernel<D, STATS>;
  smem = smem_bytes<D>(d, k, STATS);
  // The cached setup is per device: cudaFuncSetAttribute acts on the
  // calling thread's current device alone. One lock an instantiation keeps
  // the raised limit and the occupancy that goes with it consistent when
  // threads launch at once.
  constexpr int kMaxDevices = 64;
  struct Setup {
    int sms = 0, occ = 0;
    size_t attr_smem = 48 * 1024, occ_smem = (size_t)-1;
  };
  static Setup setup[kMaxDevices];
  static std::mutex lock;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return cudaErrorInvalidDevice;
  int sms, occ;
  {
    std::lock_guard<std::mutex> guard(lock);
    Setup& s = setup[dev];
    if (s.sms == 0)
      cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, dev);
    if (smem > s.attr_smem) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
      s.attr_smem = smem;
    }
    if (smem != s.occ_smem) {
      const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &s.occ, kernel, kThreads, smem);
      if (e != cudaSuccess) return e;
      if (s.occ < 1) return cudaErrorInvalidConfiguration;
      s.occ_smem = smem;
    }
    sms = s.sms;
    occ = s.occ;
  }
  const long long tiles = ((long long)n + Shape<D>::kRows - 1) /
                          Shape<D>::kRows;
  blocks = (int)min(tiles, (long long)occ * sms);
  return cudaSuccess;
}

// The statistics form's scratch for a grid of `blocks`: 1 + groups ticket
// counters, padded to 32 bytes, then the (blocks + groups, e_pad) partial
// rows. Returns its size in floats.
size_t stats_scratch(int blocks, int d, int k, int& groups, int& e_pad) {
  groups = (blocks + kGroup - 1) / kGroup;
  e_pad = (k * (d + 1) + 1 + 7) & ~7;
  return (size_t)((1 + groups + 7) & ~7) +
         (size_t)(blocks + groups) * e_pad;
}

template <int D, bool STATS>
cudaError_t launch(Args a, size_t scratch_bytes, cudaStream_t stream) {
  int blocks;
  size_t smem;
  cudaError_t e = plan<D, STATS>(a.n, a.d, a.k, blocks, smem);
  if (e != cudaSuccess) return e;
  if (STATS) {
    int groups, e_pad;
    if (stats_scratch(blocks, a.d, a.k, groups, e_pad) * sizeof(float) >
        scratch_bytes)
      return cudaErrorInvalidValue;
    a.ticket = reinterpret_cast<unsigned int*>(a.partial);
    a.partial += (1 + groups + 7) & ~7;
    e = cudaMemsetAsync(a.ticket, 0, (1 + groups) * sizeof(unsigned int),
                        stream);
    if (e != cudaSuccess) return e;
  }
  kmeans_assign_kernel<D, STATS>
      <<<(unsigned)blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// f(std::integral_constant<int, D>{}) for the kernel's instantiation of
// width d: D = d for d <= 16, else the looped form D = 0.
template <typename F>
cudaError_t with_width(int d, F f) {
  switch (d) {
#define KMEANS_CASE(W) \
  case W:              \
    return f(std::integral_constant<int, W>{});
    KMEANS_CASE(1) KMEANS_CASE(2) KMEANS_CASE(3) KMEANS_CASE(4)
    KMEANS_CASE(5) KMEANS_CASE(6) KMEANS_CASE(7) KMEANS_CASE(8)
    KMEANS_CASE(9) KMEANS_CASE(10) KMEANS_CASE(11) KMEANS_CASE(12)
    KMEANS_CASE(13) KMEANS_CASE(14) KMEANS_CASE(15) KMEANS_CASE(16)
#undef KMEANS_CASE
    default:
      return f(std::integral_constant<int, 0>{});
  }
}

}  // namespace

extern "C" int kmeans_assign_launch(const void* x, const void* c, void* labels,
                                    void* dist, int n, int d, int k,
                                    void* stream) {
  Args a{};
  a.x = (const float*)x;
  a.c = (const float*)c;
  a.labels = (int32_t*)labels;
  a.dist = (float*)dist;
  a.n = n;
  a.d = d;
  a.k = k;
  return (int)with_width(d, [&](auto w) {
    return launch<decltype(w)::value, false>(a, 0, (cudaStream_t)stream);
  });
}

// The bytes of scratch that kmeans_assign_stats_launch needs at width d
// with k centroids, for any number of rows, on the current device; fails
// if a block's shared memory does not fit.
extern "C" int kmeans_assign_stats_scratch(int d, int k, long long* bytes) {
  return (int)with_width(d, [&](auto w) {
    int blocks, groups, e_pad;
    size_t smem;
    const cudaError_t e =
        plan<decltype(w)::value, true>(INT_MAX, d, k, blocks, smem);
    if (e == cudaSuccess)
      *bytes = (long long)(stats_scratch(blocks, d, k, groups, e_pad) *
                           sizeof(float));
    return e;
  });
}

// The statistics form: labels (n,), counts (k,), sums (k, d), inertia ().
// scratch holds scratch_bytes (at least kmeans_assign_stats_scratch's) and
// is the launch's alone until it ends: its ticket counters are zeroed on
// the stream before the kernel.
extern "C" int kmeans_assign_stats_launch(const void* x, const void* c,
                                          void* labels, void* counts,
                                          void* sums, void* inertia,
                                          void* scratch,
                                          long long scratch_bytes, int n,
                                          int d, int k, void* stream) {
  Args a{};
  a.x = (const float*)x;
  a.c = (const float*)c;
  a.labels = (int32_t*)labels;
  a.partial = (float*)scratch;
  a.counts = (float*)counts;
  a.sums = (float*)sums;
  a.inertia = (float*)inertia;
  a.n = n;
  a.d = d;
  a.k = k;
  return (int)with_width(d, [&](auto w) {
    return launch<decltype(w)::value, true>(a, (size_t)scratch_bytes,
                                            (cudaStream_t)stream);
  });
}
