// ELL sparse products of the SC_RB eigensolver for Hopper:
//   z_matmul     y = diag(s) * Z * V    (gather,  (N, K))
//   zt_matmul    q = Z^T * diag(s) * u  (scatter, (D, K))
//   gram_matmul  y = diag(s) * Z * Z^T * diag(s) * u  (both, one call)
// where Z is the RB feature matrix in ELL form, idx int32 (N, R), one
// structural 1 per (row, grid).
//
// Replaces: src/repro/kernels/ell_spmm.py, z_matmul_pallas
// (_z_matmul_kernel), zt_matmul_pallas (_zt_matmul_kernel) and
// gram_matmul_pallas (_gram_matmul_kernel). The TPU kernels turn the
// gather and the scatter into one-hot products on the MXU; the TPU's Gram
// kernel keeps q in VMEM between its scatter and gather phases.
//
// What bounds them on the card: bytes, in two places. Each product reads
// idx (or its column-sorted copy) once: N*R*4 = 595 MB at the main path's
// N = 581,012, R = 256, 0.18 ms at 3.35 TB/s, for only N*R*K multiply-adds.
// The gathered rows of V (or of u) come from L2 as long as the operand fits
// there (u: 25.6 MB at K = 11), so in practice the rate of L2 sector
// gathers sets the pace: N*R gathers of a K-wide row.
//
// z_matmul has two routes, chosen by shape alone (ops.z_strip_plan):
//
// Strip route (z_strip_kernel), the main path's. It leans on the strip
// contract of the RB pattern: idx[i, r] lies in [r*d_g, (r+1)*d_g), so grid
// r reads only the strip V[r*d_g:(r+1)*d_g] (90 KB at d_g = 2,048, K = 11).
// A block owns a tile of rows and walks r = 0 ... R-1: bulk copies stream
// each strip into a ring in shared memory (mbarrier-guarded), TMA boxes
// bring the tile's idx 8 grids (one 32-byte L2 sector a row) at a time, and
// 16 warps gather from the strip in shared memory, not from L2. A thread
// holds up to 8 rows x KC columns of float32 sums in registers. KC (4, 2
// or 1) splits K into column groups (V repacked per call into (groups, D,
// KC), zero-padded) so that a tile can hold 4,096 rows: strip traffic is
// (blocks) * D*KC*4 bytes, idx is read once per group (the groups of a tile
// are neighbouring blocks, so the repeats hit L2). Tiles are cut so that
// the blocks fill whole waves of one block an SM. Each y[i, k] is summed
// over r = 0 ... R-1 in order and scaled once: the same bits as the gather
// route. It needs R a multiple of 8, d_g a power of two, and a strip of
// d_g*KC elements (16-byte multiple) that fits at least twice beside the
// 128 KB idx buffer (the fit's shape gets 3 stages). What bounds it:
// shared-memory gathers of 16 bytes at random addresses (about 2.6-way
// bank conflicts), then the L2 traffic of strips and idx.
//
// Gather route, for every other shape: every RB predict batch (the
// degrees' one-column gather and the K-wide projection, below
// Z_STRIP_MIN_ROWS rows) and the ragged last chunk of a host-chunked fit.
// Two forms, chosen by shape alone (ops.z_gather_plan):
//
// Register form (z_gather_rows_kernel), for batches of 10,240 outputs
// (rows x K) or more, and at R <= 32: one thread per (row, k),
// neighbouring k of a row in neighbouring lanes (one gathered V
// row a few lanes wide). A thread loads 32 idx entries of its row (16-byte
// loads where aligned), issues their 32 V gathers at once, and adds them
// to its float32 sum in grid order; a row of R = 256 grids is 8 such
// rounds. What bounds it: once the batch fills the card, the L1's
// processing of scattered load instructions (each touches a few 128-byte
// lines); below that, the 8 dependent rounds.
//
// Staged form (z_gather_kernel), for the smaller batches, where a thread
// per (row, k) leaves most SMs idle and the rounds' latency is the time. A
// warp owns P rows (P = 1 at R = 256) and a column group of KC columns,
// and walks the grids in passes of up to 256:
//   1. its lanes copy the rows' idx entries of the pass into shared memory
//      (16-byte loads where aligned: one round trip);
//   2. every lane issues its share of the P x grids x KC gathers at once
//      (cp.async of 4 bytes for float32 V, so none waits for another;
//      batches of 8 through registers for bfloat16): neighbouring lanes
//      take neighbouring columns of one gathered V row; each value lands
//      in a staged column (grids, padded to a stride of 4 mod 8 floats: no
//      bank conflict for the 16-byte reads below) in shared memory, as
//      float32;
//   3. P x KC lanes each fold their column over the pass's grids, in
//      order, 16 bytes at a time, in a float32 register kept across
//      passes, and scale once at the end.
// So a batch's memory chain is two round trips, and a 64-row batch spreads
// over 64 SMs. What bounds it: the launch, the two round trips and the
// fold's R dependent adds (about 4 cycles each).
//
// Both forms compute each y[i, k] as acc = 0; acc += float(v[idx[i, r],
// k]) for r = 0 ... R-1; y = acc * s[i]: the strip kernel's order, so
// every route gives the same bits.
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
//
// gram_matmul design, for the shapes of the strip route: zt's steps, then
// the strip kernel, in one entry point, each kernel a programmatic
// dependent of the one before (it starts while that one finishes, and
// waits for it with griddepcontrol.wait), so the launch gaps overlap the
// tails. The scatter (gram_scatter_kernel, at zt_main's block shape)
// writes q straight into the strip kernel's column-group layout, so no
// repack pass runs, and q (23 MB at the fit's shape) stays in L2 for the
// gather (the H100's L2 plays the part of the TPU's VMEM). It keeps both
// kernels' sums (zt_sums, z_strip_kernel), so y has the bits of zt_matmul
// then z_matmul and LOBPCG's iterations do not move. Any Z(Z^T u) reads
// the pattern twice (q needs every row before any y row can be formed,
// and the 595 MB pattern does not fit L2): its bytes bound is the CSC row
// ids, the column pointer, idx, u, s and y, 1.248 GB or 0.372 ms at the
// fit's shape. (A single cooperative launch of one 16-warp block an SM,
// grid-wide barriers between the phases, was 1.2 ms slower on the H100:
// its scatter had a quarter of zt_main's warps in flight; PERF.md.)
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <utility>

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

// The gather kernels' block: at most 4 warps (ops.z_gather_plan).
constexpr int kGatherMaxWarps = 4;
// Grids a thread of the register form has in flight.
constexpr int kRowsAhead = 32;

// Register form (ops.z_gather_plan route 1); see "Gather route" above.
template <typename T>
__global__ void __launch_bounds__(kGatherMaxWarps * 32)
z_gather_rows_kernel(const int32_t* __restrict__ idx, const T* __restrict__ v,
                     const float* __restrict__ s, T* __restrict__ out, int n,
                     int r, int k) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long long)n * k) return;
  const long long i = gid / k;
  const int kk = (int)(gid - i * k);
  const int32_t* row = idx + i * r;
  const T* vk = v + kk;
  const bool by16 = (reinterpret_cast<uintptr_t>(row) & 15) == 0;
  float acc = 0.f;
  int g = 0;
  for (; g + kRowsAhead <= r; g += kRowsAhead) {
    int c[kRowsAhead];
    if (by16) {
#pragma unroll
      for (int u = 0; u < kRowsAhead; u += 4) {
        const int4 q = __ldg(reinterpret_cast<const int4*>(row + g + u));
        c[u] = q.x;
        c[u + 1] = q.y;
        c[u + 2] = q.z;
        c[u + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int u = 0; u < kRowsAhead; ++u) c[u] = __ldg(row + g + u);
    }
    float x[kRowsAhead];
#pragma unroll
    for (int u = 0; u < kRowsAhead; ++u)
      x[u] = to_float(__ldg(vk + (size_t)c[u] * k));
#pragma unroll
    for (int u = 0; u < kRowsAhead; ++u) acc += x[u];
  }
  for (; g < r; ++g) acc += to_float(__ldg(vk + (size_t)__ldg(row + g) * k));
  store(out + gid, acc * s[i]);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// Staged form (route 0): one warp per (tile of `rows` rows, column group
// of kc columns); see "Gather route" above. Shared memory per warp: the
// pass's idx entries (rows * chunk int32, rounded up to 4) then rows * kc
// staged columns of `stride` floats.
template <typename T>
__global__ void __launch_bounds__(kGatherMaxWarps * 32)
z_gather_kernel(const int32_t* __restrict__ idx, const T* __restrict__ v,
                const float* __restrict__ s, T* __restrict__ out, int n,
                int r, int k, int kc, int rows, int chunk, int stride,
                long long items) {
  extern __shared__ __align__(16) int32_t gather_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long item = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (item >= items) return;
  const int groups = (k + kc - 1) / kc;
  const long long tile = item / groups;
  const int c0 = (int)(item - tile * groups) * kc;
  const int kce = min(kc, k - c0);
  const long long row0 = tile * rows;
  const int pv = (int)min((long long)rows, (long long)n - row0);
  const int idx_ints = (rows * chunk + 3) & ~3;
  int32_t* idx_s = gather_smem + (size_t)warp * (idx_ints + rows * kc * stride);
  float* stage = reinterpret_cast<float*>(idx_s + idx_ints);
  const int folders = pv * kce;              // lanes that fold a column
  const int dk = 32 % kce, dr = 32 / kce;    // a lane's step in (g, kk)
  float acc = 0.f;
  for (int g0 = 0; g0 < r; g0 += chunk) {
    const int rc = min(chunk, r - g0);
    // 1. idx of the pass: pv rows of rc entries, contiguous (rows > 1 only
    // when one pass holds all R grids)
    const int32_t* src = idx + row0 * r + g0;
    const int len = pv * rc;
    int j0 = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      j0 = len & ~3;
      for (int j = lane * 4; j < j0; j += 128)
        *reinterpret_cast<int4*>(idx_s + j) =
            __ldg(reinterpret_cast<const int4*>(src + j));
    }
    for (int j = j0 + lane; j < len; j += 32) idx_s[j] = __ldg(src + j);
    __syncwarp();
    // 2. every gather of the pass: element e = (p * rc + g) * kce + kk for
    // e = lane, lane + 32, ..., walked incrementally
    const int total = len * kce;
    int kk = lane % kce, g = lane / kce, p = g / rc;
    g -= p * rc;
    auto advance = [&]() {
      kk += dk;
      g += dr;
      if (kk >= kce) {
        kk -= kce;
        ++g;
      }
      if (g >= rc) {
        const int q = g / rc;
        p += q;
        g -= q * rc;
      }
    };
    if constexpr (sizeof(T) == 4) {          // all in flight: cp.async
      for (int e = lane; e < total; e += 32) {
        const int col = idx_s[p * rc + g];
        cp_async4(stage + (p * kce + kk) * stride + g,
                  reinterpret_cast<const float*>(v) + (size_t)col * k + c0 +
                      kk);
        advance();
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    } else {                                 // batches through registers
      constexpr int kBatch = 8;
      for (int e = lane; e < total; e += 32 * kBatch) {
        float val[kBatch];
        int dst[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          dst[u] = -1;
          if (e + 32 * u < total) {
            const int col = idx_s[p * rc + g];
            dst[u] = (p * kce + kk) * stride + g;
            val[u] = to_float(__ldg(v + (size_t)col * k + c0 + kk));
            advance();
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (dst[u] >= 0) stage[dst[u]] = val[u];
      }
    }
    __syncwarp();
    // 3. the in-order fold of this lane's column over the pass
    if (lane < folders) {
      const float* c = stage + lane * stride;
      int j = 0;
      for (; j + 4 <= rc; j += 4) {
        const float4 q = *reinterpret_cast<const float4*>(c + j);
        acc += q.x;
        acc += q.y;
        acc += q.z;
        acc += q.w;
      }
      for (; j < rc; ++j) acc += c[j];
    }
    __syncwarp();  // the next pass overwrites idx_s and stage
  }
  if (lane < folders) {
    const int p = lane / kce, c = lane - p * kce;
    store(out + (row0 + p) * k + c0 + c, acc * s[row0 + p]);
  }
}

// Programmatic dependent launch: a kernel launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may start while the
// kernel before it on the stream finishes; grid_dependency_wait blocks
// until that kernel has completed and its writes are visible (a no-op in an
// ordinary launch), and grid_dependency_trigger lets the next one start.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void grid_dependency_trigger() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
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
  grid_dependency_trigger();  // the Gram product's scatter may start
}

// The bounds [p0, p1) in the CSC tables of zt's work item w: column w for
// w < d, else chunk w - d of a long column.
__device__ __forceinline__ void zt_item(const int64_t* colptr,
                                        const int32_t* long_cols,
                                        const int64_t* long_chunk_ptr,
                                        const int32_t* chunk_long,
                                        long long w, long long d, int chunk,
                                        long long& p0, long long& p1) {
  if (w < d) {
    p0 = colptr[w];
    p1 = colptr[w + 1];
  } else {
    const long long c = w - d;
    const int li = chunk_long[c];
    const int col = long_cols[li];
    p0 = colptr[col] + (c - long_chunk_ptr[li]) * chunk;
    p1 = min(p0 + chunk, (long long)colptr[col + 1]);
  }
}

// One warp's sums over the nonzeros [p0, p1) of the CSC tables: 1 << log2l
// lanes share a nonzero (one float4 group of its padded su row each) and
// slot = lane >> log2l takes nonzeros p0 + slot, p0 + slot + slots, ... in
// order, kInFlight gathers in flight at a time; then a fixed shuffle tree
// adds the slots. emit(g, sum) runs on slot 0's lanes, once per float4
// group g of the row. Each lane adds in order, so the unroll does not
// change the bits. kL2 reads su through L2 only (su written by the kernel
// this one depends on).
constexpr int kInFlight = 4;

template <bool kL2, typename Emit>
__device__ __forceinline__ void zt_sums(const int32_t* __restrict__ rows,
                                        const float4* su, long long p0,
                                        long long p1, int groups, int log2l,
                                        Emit emit) {
  const int lane = threadIdx.x & 31;
  const int l = 1 << log2l, slots = 32 >> log2l;
  const int slot = lane >> log2l, sub = lane & (l - 1);
  auto ld = [&](int32_t row, int g) {
    const float4* p = su + (long long)row * groups + g;
    return kL2 ? __ldcg(p) : __ldg(p);
  };
  for (int g0 = 0; g0 < groups; g0 += l) {
    const int g = g0 + sub;
    const bool active = g < groups;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    long long p = p0 + slot;
    for (; p + (kInFlight - 1) * slots < p1; p += kInFlight * slots) {
      int32_t rr[kInFlight];
#pragma unroll
      for (int q = 0; q < kInFlight; ++q) rr[q] = rows[p + q * slots];
      if (active) {
        float4 v[kInFlight];
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) v[q] = ld(rr[q], g);
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) add4(acc, v[q]);
      }
    }
    for (; p < p1; p += slots)
      if (active) add4(acc, ld(rows[p], g));
#pragma unroll
    for (int off = 16; off >= l; off >>= 1) {
      acc.x += __shfl_down_sync(0xffffffffu, acc.x, off);
      acc.y += __shfl_down_sync(0xffffffffu, acc.y, off);
      acc.z += __shfl_down_sync(0xffffffffu, acc.z, off);
      acc.w += __shfl_down_sync(0xffffffffu, acc.w, off);
    }
    if (slot == 0 && active) emit(g, acc);
  }
}

// The k columns of a float4 group's sums into a k-wide row (the pad
// columns k..kp-1 are not stored).
__device__ __forceinline__ void store_k(float* row, int g, int k,
                                        const float4& acc) {
  float* o = row + 4 * g;
  o[0] = acc.x;
  if (4 * g + 1 < k) o[1] = acc.y;
  if (4 * g + 2 < k) o[2] = acc.z;
  if (4 * g + 3 < k) o[3] = acc.w;
}

__host__ __device__ constexpr int ilog2(int v) {
  return v <= 1 ? 0 : 1 + ilog2(v >> 1);
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
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (w >= d + n_chunks) return;  // whole warps leave together
  long long p0, p1;
  zt_item(colptr, long_cols, long_chunk_ptr, chunk_long, w, d, chunk, p0, p1);
  if (w < d && p1 - p0 > chunk) return;  // a long column: its chunks' warps
  float* out = w < d ? q + w * k : partial + (w - d) * k;
  zt_sums<false>(rows, su, p0, p1, kp / 4, ilog2(L),
                    [&](int g, const float4& acc) { store_k(out, g, k, acc); });
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

// --------------------------------------------------------------------------
// z_matmul, strip route: grid strips of V in shared memory
// --------------------------------------------------------------------------

constexpr int kStripConsumers = 512;            // 16 warps
constexpr int kStripRows = 8;                   // rows per consumer thread
constexpr int kIdxGrids = 8;                    // grids per idx chunk
constexpr int kMaxStages = 6;
constexpr int kHeaderBytes = 1024;  // barriers, then idx at 1 KB alignment

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` has completed. No wait of this
// kernel lasts more than microseconds; one that lasts 10 s traps. The
// clock is read only once a wait has spun for a while.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (uint32_t tries = 1;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((tries & 1023u) == 0) {
      const uint64_t t = global_ns();
      if (t0 == 0)
        t0 = t;
      else if (t - t0 > 10000000000ull)
        __trap();
    }
  }
}

// One contiguous run of bytes, global -> shared, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

template <int BYTES> struct Raw;
template <> struct Raw<2> { using type = uint16_t; };
template <> struct Raw<4> { using type = uint32_t; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

// repack: vp[cg][row][j] = v[row][cg*KC + j], 0 past k; T stays T.
template <typename T, int KC>
__global__ void __launch_bounds__(kThreads)
z_strip_repack_kernel(const T* __restrict__ v, T* __restrict__ vp,
                      long long d, int k, int groups) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long long)groups * d * KC) return;
  const int j = (int)(gid % KC);
  const long long row = (gid / KC) % d;
  const int col = (int)(gid / (KC * d)) * KC + j;
  vp[gid] = col < k ? v[row * k + col] : zero<T>();
}

// One box of the 2-D idx map (grid c0.., row c1..), completing on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* tm,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Block (tile, cg): rows [tile*tile_rows, (tile+1)*tile_rows) of y
// (tile_rows <= 512*M, a multiple of 32), columns cg*KC.. of its column
// group. Warp w owns the rows from w*32*M on, in groups of 32 (those past
// tile_rows are left idle); its lane l holds rows w*32*M + 32*m + l and KC
// columns of each.
//   Strips: thread 0 keeps the strip ring full. Strip r is
//     vp[cg][r*d_g:(r+1)*d_g], one bulk copy of d_g*KC elements into one of
//     `stages` stages, guarded by a full and an empty mbarrier (one arrival
//     a warp). It refills a stage once every warp is done with it.
//   idx: chunks of 8 grids (32 bytes, one L2 sector, of each row). Each
//     warp fetches its own rows' chunk with one TMA box (8 grids x 32*M
//     rows, 32-byte swizzle, so that its lanes' 16-byte reads of 32
//     neighbouring rows meet no bank conflict) on a barrier of its own; it
//     reads 4 grids a row into registers at a time, and once it has read
//     the second 4 it asks for the next chunk.
//   Sums: V[idx[i, r], cols] for r = 0, 1, ..., R-1, in order, in float32
//     registers, scaled by s[i] once, as z_gather_kernel does.
// Thread 0 reads vp only after grid_dependency_wait: the Gram product
// launches this kernel as a programmatic dependent of its scatter.
template <typename T, int KC, int M>
__global__ void __launch_bounds__(kStripConsumers, 1)
z_strip_kernel(const __grid_constant__ CUtensorMap tm_idx,
               const T* __restrict__ vp, const float* __restrict__ s,
               T* __restrict__ out, int n, int r, int d_g, int k, int groups,
               int tile_rows, int stages, int stage_stride) {
  constexpr int kWarpRows = 32 * M;
  constexpr int kRows = kStripConsumers * M;
  constexpr uint32_t kBoxBytes = kWarpRows * kIdxGrids * 4;
  static_assert(kWarpRows <= 256, "a TMA box has at most 256 rows");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the launch adds 1 KB so that the idx boxes start 1024-byte aligned
  unsigned char* smem =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(smem);
  const uint32_t full_s = base, empty_s = base + 8 * kMaxStages;
  const uint32_t full_i = base + 16 * kMaxStages;  // one per warp
  const unsigned char* idx_s = smem + kHeaderBytes;
  const uint32_t idx_u32 = base + kHeaderBytes;
  const unsigned char* strip_ring = idx_s + kRows * kIdxGrids * 4;
  const uint32_t strip_u32 = idx_u32 + kRows * kIdxGrids * 4;

  const int tile = blockIdx.x / groups;
  const int cg = blockIdx.x - tile * groups;
  const uint32_t strip_bytes = (uint32_t)(d_g * KC * sizeof(T));
  const T* src = vp + (size_t)cg * r * d_g * KC;
  const int chunks = r / kIdxGrids;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool producer = t == 0;
  const uint32_t my_full_i = full_i + 8 * warp;
  const uint32_t my_box = idx_u32 + warp * kBoxBytes;
  // the warp's first row in the tile, and its groups of 32 rows in it
  const int my_first = warp * kWarpRows;
  const int my_groups = min(M, max(0, (tile_rows - my_first + 31) / 32));
  const int my_row0 = tile * tile_rows + my_first;

  auto load_strip = [&](int g, int st) {
    mbar_expect_tx(full_s + 8 * st, strip_bytes);
    bulk_load(strip_u32 + st * stage_stride, src + (size_t)g * d_g * KC,
              strip_bytes, full_s + 8 * st);
  };
  auto load_idx = [&](int c) {  // lane 0: this warp's box of chunk c
    mbar_expect_tx(my_full_i, kBoxBytes);
    tma_load_2d(my_box, &tm_idx, c * kIdxGrids, my_row0, my_full_i);
  };

  if (producer) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full_s + 8 * i, 1);
      mbar_init(empty_s + 8 * i, kStripConsumers / 32);
    }
    for (int i = 0; i < kStripConsumers / 32; ++i) mbar_init(full_i + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // launched as a dependent of the kernel that writes vp (the Gram
    // product's scatter): wait for it to finish before reading vp; a no-op
    // in an ordinary launch
    grid_dependency_wait();
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    for (int i = 0; i < stages && i < r; ++i) load_strip(i, i);
  }
  __syncthreads();
  if (lane == 0 && my_groups > 0) load_idx(0);

  using V = typename Raw<KC * sizeof(T)>::type;
  const uint32_t mask = (uint32_t)d_g - 1u;
  float acc[M][KC];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < KC; ++j) acc[m][j] = 0.f;
  int st = 0;
  uint32_t phase = 0;
  for (int c = 0; c < chunks; ++c) {
    if (my_groups > 0) mbar_wait(my_full_i, c & 1);
    uint4 id[M];  // grids 8c..8c+3, then 8c+4..8c+7, of each row
#pragma unroll
    for (int j = 0; j < kIdxGrids; ++j) {
      if ((j & 3) == 0) {
        // row q of the box, half h: 16 bytes at 32q + 16 (h ^ bit 2 of q)
#pragma unroll
        for (int m = 0; m < M; ++m) {
          if (m >= my_groups) break;
          const int q = 32 * m + lane;
          id[m] = *reinterpret_cast<const uint4*>(
              idx_s + warp * kBoxBytes +
              32 * q + 16 * ((j >> 2) ^ ((q >> 2) & 1)));
        }
      }
      const int g = c * kIdxGrids + j;
      mbar_wait(full_s + 8 * st, phase);
      const V* strip =
          reinterpret_cast<const V*>(strip_ring + st * stage_stride);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        if (m >= my_groups) break;  // rows of the next tile
        const uint32_t gi = (j & 3) == 0 ? id[m].x : (j & 3) == 1 ? id[m].y
                          : (j & 3) == 2 ? id[m].z : id[m].w;
        V raw = strip[gi & mask];
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int q = 0; q < KC; ++q) acc[m][q] += to_float(e[q]);
      }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(empty_s + 8 * st);
        // the warp has read the chunk's second halves: fetch the next one
        if (j == 4 && c + 1 < chunks && my_groups > 0) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          load_idx(c + 1);
        }
      }
      if (producer && g + stages < r) {  // refill this stage: strip g+stages
        mbar_wait(empty_s + 8 * st, phase);
        load_strip(g + stages, st);
      }
      if (++st == stages) {
        st = 0;
        phase ^= 1u;
      }
    }
  }
  const int cols = min(KC, k - cg * KC);
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int row = my_row0 + 32 * m + lane;
    if (m < my_groups && my_first + 32 * m + lane < tile_rows && row < n) {
      const float sc = s[row];
      T* o = out + (size_t)row * k + cg * KC;
#pragma unroll
      for (int q = 0; q < KC; ++q)
        if (q < cols) store(o + q, acc[m][q] * sc);
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

constexpr int kSmemMax = 232448;  // a block's shared memory on the H100

// Launch setup is per device: cudaFuncSetAttribute acts on the calling
// thread's current device alone, so a limit lifted on one card is still the
// default on the next. The flags below are kept per device ordinal.
constexpr int kMaxDevices = 64;

// The calling thread's device, or -1 if it has none or an ordinal past
// kMaxDevices.
int current_device() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return -1;
  return dev;
}

int sm_count() {
  static std::atomic<int> sms[kMaxDevices] = {};
  const int dev = current_device();
  if (dev < 0) return 0;
  int n = sms[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    sms[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

// A strip launch's geometry and its idx tensor map; plan_strip also lifts
// the strip kernel's shared-memory limit, once per instantiation and device.
struct StripPlan {
  CUtensorMap map;
  int stage_stride, smem, groups, tile_rows, n_items;
};

template <typename T, int KC, int M>
cudaError_t plan_strip(const void* idx, int n, int r, int d_g, int k,
                       int stages, StripPlan& p) {
  constexpr int kRows = kStripConsumers * M;
  p.stage_stride = (int)((d_g * KC * sizeof(T) + 127) / 128 * 128);
  p.smem = 1024 + kHeaderBytes + kRows * kIdxGrids * 4 +
           stages * p.stage_stride;
  if (stages < 2 || stages > kMaxStages || p.smem > kSmemMax ||
      r % kIdxGrids)
    return cudaErrorInvalidValue;
  // once per instantiation of the kernel and device; two threads that
  // both see false set the same value twice, which is harmless
  static std::atomic<bool> smem_set[kMaxDevices] = {};
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  if (!smem_set[dev].load(std::memory_order_acquire)) {
    const cudaError_t e = cudaFuncSetAttribute(
        z_strip_kernel<T, KC, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemMax);
    if (e != cudaSuccess) return e;
    smem_set[dev].store(true, std::memory_order_release);
  }
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // idx (n, r) int32 as a 2-D map cut into boxes of 8 grids x 32*M rows;
  // rows past n read as 0
  const cuuint64_t dims[2] = {(cuuint64_t)r, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)r * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kIdxGrids, (cuuint32_t)(32 * M)};
  const cuuint32_t elem_strides[2] = {1, 1};
  if (encode(&p.map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, const_cast<void*>(idx),
             dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_32B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  p.groups = (k + KC - 1) / KC;
  // as many tiles as fill the waves that tiles of kRows rows need, so that
  // the last wave is as full as the others (one block an SM)
  const int sms = sm_count();
  const long long min_tiles = (n + kRows - 1) / kRows;
  const long long waves = (min_tiles * p.groups + sms - 1) / sms;
  const long long tiles = max(min_tiles, waves * sms / p.groups);
  p.tile_rows = (int)(((n + tiles - 1) / tiles + 31) / 32 * 32);
  p.n_items = (int)((n + p.tile_rows - 1) / p.tile_rows) * p.groups;
  return cudaSuccess;
}

template <typename T, int KC, int M>
cudaError_t launch_strip(const void* idx, const void* v, const void* s,
                         void* vp, void* out, int n, int r, int d_g, int k,
                         int stages, cudaStream_t stream) {
  StripPlan p;
  cudaError_t e = plan_strip<T, KC, M>(idx, n, r, d_g, k, stages, p);
  if (e != cudaSuccess) return e;
  const long long d = (long long)r * d_g;
  const long long total = (long long)p.groups * d * KC;
  z_strip_repack_kernel<T, KC>
      <<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
          (const T*)v, (T*)vp, d, k, p.groups);
  z_strip_kernel<T, KC, M><<<p.n_items, kStripConsumers, p.smem, stream>>>(
      p.map, (const T*)vp, (const float*)s, (T*)out, n, r, d_g, k, p.groups,
      p.tile_rows, stages, p.stage_stride);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_strip_t(const void* idx, const void* v, const void* s,
                           void* vp, void* out, int n, int r, int d_g, int k,
                           int kc, int stages, cudaStream_t st) {
  switch (kc) {
    case 1:
      return launch_strip<T, 1, kStripRows>(idx, v, s, vp, out, n, r, d_g, k,
                                            stages, st);
    case 2:
      return launch_strip<T, 2, kStripRows>(idx, v, s, vp, out, n, r, d_g, k,
                                            stages, st);
    case 4:
      return launch_strip<T, 4, kStripRows>(idx, v, s, vp, out, n, r, d_g, k,
                                            stages, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// --------------------------------------------------------------------------
// gram_matmul: y = diag(s) Z Z^T diag(s) u, three kernels chained by
// programmatic dependent launch
// --------------------------------------------------------------------------

// A float4 group g of q's column `col` into the strip layout qp[cg][col][j]
// (cg = column / KC, j = column % KC), the layout z_strip_repack_kernel
// makes; the columns k.. up to width = groups*KC hold the zero sums of
// su's pad.
template <int KC>
__device__ __forceinline__ void store_grouped(float* qp, long long d,
                                              long long col, int g,
                                              int width, const float4& acc) {
  if constexpr (KC == 4) {
    reinterpret_cast<float4*>(qp)[g * d + col] = acc;
  } else {
    const float v[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = 4 * g + c;
      if (j < width) qp[((j / KC) * d + col) * KC + j % KC] = v[c];
    }
  }
}

// The Gram product's scatter: zt_main_kernel's work items and sums, with
// short columns written straight into the strip layout qp (width = groups
// * KC columns, pad included) and chunks of long columns into partial. A
// programmatic dependent of zt_prescale_kernel.
template <int L, int KC>
__global__ void __launch_bounds__(kThreads)
gram_scatter_kernel(const int32_t* __restrict__ rows,
                    const int64_t* __restrict__ colptr,
                    const int32_t* __restrict__ long_cols,
                    const int64_t* __restrict__ long_chunk_ptr,
                    const int32_t* __restrict__ chunk_long,
                    const float4* su, float* __restrict__ qp,
                    float* __restrict__ partial, int d, long long n_chunks,
                    int k, int kp, int width, int chunk) {
  grid_dependency_wait();  // su is complete
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (w < d + n_chunks) {
    long long p0, p1;
    zt_item(colptr, long_cols, long_chunk_ptr, chunk_long, w, d, chunk, p0,
            p1);
    if (w >= d) {
      float* out = partial + (w - d) * k;
      zt_sums<true>(rows, su, p0, p1, kp / 4, ilog2(L),
                       [&](int g, const float4& acc) {
                         store_k(out, g, k, acc);
                       });
    } else if (p1 - p0 <= chunk) {  // a long column is its chunks' items
      zt_sums<true>(rows, su, p0, p1, kp / 4, ilog2(L),
                       [&](int g, const float4& acc) {
                         store_grouped<KC>(qp, d, w, g, width, acc);
                       });
    }
  }
  grid_dependency_trigger();
}

// The long columns' chunk sums in order (zt_combine_kernel's), into qp; a
// programmatic dependent of gram_scatter_kernel.
template <int KC>
__global__ void __launch_bounds__(kThreads)
gram_combine_kernel(const int32_t* __restrict__ long_cols,
                    const int64_t* __restrict__ long_chunk_ptr,
                    const float* partial, float* __restrict__ qp,
                    long long d, int n_long, int k, int width) {
  grid_dependency_wait();  // the chunk sums are complete
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid < (long long)n_long * width) {
    const int li = (int)(gid / width);
    const int j = (int)(gid - (long long)li * width);
    float acc = 0.f;
    if (j < k)
      for (long long c = long_chunk_ptr[li]; c < long_chunk_ptr[li + 1]; ++c)
        acc += __ldcg(partial + c * k + j);
    qp[((j / KC) * d + long_cols[li]) * KC + j % KC] = acc;
  }
  grid_dependency_trigger();
}

// Launch `kernel` so that it may start while the previous kernel on the
// stream finishes; it waits for it with grid_dependency_wait.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), unsigned blocks,
                             unsigned threads, size_t smem,
                             cudaStream_t stream, Args&&... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
}

template <int L, int KC>
cudaError_t launch_gram_chain(const void* rows, const void* colptr,
                              const void* long_cols,
                              const void* long_chunk_ptr,
                              const void* chunk_long, const void* idx,
                              const void* u, const void* s, void* su,
                              void* partial, void* qp, void* y, int n, int r,
                              int d_g, int k, int kp, int stages, int n_long,
                              long long n_chunks, int chunk,
                              cudaStream_t stream) {
  StripPlan p;
  cudaError_t e = plan_strip<float, KC, kStripRows>(idx, n, r, d_g, k,
                                                    stages, p);
  if (e != cudaSuccess) return e;
  const int d = r * d_g;
  const int width = p.groups * KC;
  const long long pre = (long long)n * kp;
  zt_prescale_kernel<<<(unsigned)((pre + kThreads - 1) / kThreads), kThreads,
                       0, stream>>>((const float*)u, (const float*)s,
                                    (float*)su, n, k, kp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long warps = (long long)d + n_chunks;
  e = launch_dependent(
      gram_scatter_kernel<L, KC>,
      (unsigned)((warps * 32 + kThreads - 1) / kThreads), kThreads, 0, stream,
      (const int32_t*)rows, (const int64_t*)colptr,
      (const int32_t*)long_cols, (const int64_t*)long_chunk_ptr,
      (const int32_t*)chunk_long, (const float4*)su, (float*)qp,
      (float*)partial, d, n_chunks, k, kp, width, chunk);
  if (e != cudaSuccess) return e;
  if (n_long > 0) {
    const long long t = (long long)n_long * width;
    e = launch_dependent(gram_combine_kernel<KC>,
                         (unsigned)((t + kThreads - 1) / kThreads), kThreads,
                         0, stream, (const int32_t*)long_cols,
                         (const int64_t*)long_chunk_ptr,
                         (const float*)partial, (float*)qp, (long long)d,
                         n_long, k, width);
    if (e != cudaSuccess) return e;
  }
  return launch_dependent(z_strip_kernel<float, KC, kStripRows>,
                          (unsigned)p.n_items, kStripConsumers, p.smem,
                          stream, p.map, (const float*)qp, (const float*)s,
                          (float*)y, n, r, d_g, k, p.groups, p.tile_rows,
                          stages, p.stage_stride);
}

template <int KC>
cudaError_t launch_gram_kc(int l, const void* rows, const void* colptr,
                           const void* long_cols, const void* long_chunk_ptr,
                           const void* chunk_long, const void* idx,
                           const void* u, const void* s, void* su,
                           void* partial, void* qp, void* y, int n, int r,
                           int d_g, int k, int kp, int stages, int n_long,
                           long long n_chunks, int chunk, cudaStream_t st) {
#define GRAM_CHAIN(LL)                                                        \
  launch_gram_chain<LL, KC>(rows, colptr, long_cols, long_chunk_ptr,         \
                            chunk_long, idx, u, s, su, partial, qp, y, n, r, \
                            d_g, k, kp, stages, n_long, n_chunks, chunk, st)
  switch (l) {
    case 1: return GRAM_CHAIN(1);
    case 2: return GRAM_CHAIN(2);
    case 4: return GRAM_CHAIN(4);
    case 8: return GRAM_CHAIN(8);
    case 16: return GRAM_CHAIN(16);
    default: return GRAM_CHAIN(32);
  }
#undef GRAM_CHAIN
}

}  // namespace

// y (n, k) = diag(s) Z v through the gather route, on the geometry of
// ops.z_gather_plan. route 1: the register form, `warps` warps a block.
// route 0: the staged form, kc columns and `rows` rows a warp, `warps`
// warps a block, passes of `chunk` grids, staged columns of `stride`
// floats (a multiple of 4, at least chunk). v (r*d_g, k) float32 or
// bfloat16. Returns cudaErrorInvalidValue for a geometry the kernels do
// not take.
extern "C" int z_gather_launch(const void* idx, const void* v, const void* s,
                               void* out, int n, int r, int k, int route,
                               int kc, int rows, int warps, int chunk,
                               int stride, int v_is_bf16, void* stream) {
  if (n <= 0 || k <= 0) return (int)cudaGetLastError();
  if (warps < 1 || warps > kGatherMaxWarps) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (route == 1) {
    const long long total = (long long)n * k;
    const unsigned blocks =
        (unsigned)((total + warps * 32 - 1) / (warps * 32));
    if (v_is_bf16)
      z_gather_rows_kernel<__nv_bfloat16><<<blocks, warps * 32, 0, st>>>(
          (const int32_t*)idx, (const __nv_bfloat16*)v, (const float*)s,
          (__nv_bfloat16*)out, n, r, k);
    else
      z_gather_rows_kernel<float><<<blocks, warps * 32, 0, st>>>(
          (const int32_t*)idx, (const float*)v, (const float*)s,
          (float*)out, n, r, k);
    return (int)cudaGetLastError();
  }
  const long long smem =
      (long long)warps * (((rows * chunk + 3) & ~3) + rows * kc * stride) * 4;
  if (route != 0 || r < 1 || kc < 1 || kc > k || rows < 1 ||
      rows * kc > 32 || chunk < 1 || (rows > 1 && chunk < r) ||
      stride < chunk || stride % 4 || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const long long items =
      ((long long)(n + rows - 1) / rows) * ((k + kc - 1) / kc);
  const unsigned blocks = (unsigned)((items + warps - 1) / warps);
  if (v_is_bf16)
    z_gather_kernel<__nv_bfloat16><<<blocks, warps * 32, (size_t)smem, st>>>(
        (const int32_t*)idx, (const __nv_bfloat16*)v, (const float*)s,
        (__nv_bfloat16*)out, n, r, k, kc, rows, chunk, stride, items);
  else
    z_gather_kernel<float><<<blocks, warps * 32, (size_t)smem, st>>>(
        (const int32_t*)idx, (const float*)v, (const float*)s, (float*)out, n,
        r, k, kc, rows, chunk, stride, items);
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

// y (n, k) = diag(s) Z v through the strip kernel (ops.z_strip_plan picks
// kc and stages): v (r*d_g, k), vp scratch of groups*r*d_g*kc elements
// of v's type, groups = ceil(k / kc). idx (n, r) int32, 16-byte aligned,
// r a multiple of 4, d_g a power of two. Returns cudaErrorInvalidValue for
// a plan without an instantiation.
extern "C" int z_strip_launch(const void* idx, const void* v, const void* s,
                              void* vp, void* out, int n, int r, int d_g,
                              int k, int kc, int stages, int v_is_bf16,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (v_is_bf16)
    return (int)launch_strip_t<__nv_bfloat16>(idx, v, s, vp, out, n, r, d_g,
                                              k, kc, stages, st);
  return (int)launch_strip_t<float>(idx, v, s, vp, out, n, r, d_g, k, kc,
                                    stages, st);
}

// y (n, k) = diag(s) Z Z^T diag(s) u for a shape the strip route takes
// (ops.z_strip_plan picks kc and stages; float32): zt_prescale_kernel, then
// gram_scatter_kernel, gram_combine_kernel if long columns exist, and
// z_strip_kernel on q, each a programmatic dependent of the one before.
// The CSC tables as for zt_matmul_launch, idx (n, r) int32 16-byte
// aligned; su (n, kp), partial (n_chunks, k) and qp (ceil(k/kc) * r*d_g *
// kc) are scratch.
extern "C" int gram_matmul_launch(const void* rows, const void* colptr,
                                  const void* long_cols,
                                  const void* long_chunk_ptr,
                                  const void* chunk_long, const void* idx,
                                  const void* u, const void* s, void* su,
                                  void* partial, void* qp, void* y, int n,
                                  int r, int d_g, int k, int kp, int kc,
                                  int stages, int n_long, long long n_chunks,
                                  int chunk, void* stream) {
  // lanes per nonzero as zt_matmul_launch picks them: the float4 groups of
  // a padded row, rounded up to a power of two, at most 32
  int l = 1;
  while (l < kp / 4 && l < 32) l <<= 1;
  cudaStream_t st = (cudaStream_t)stream;
#define GRAM_KC(KC)                                                          \
  launch_gram_kc<KC>(l, rows, colptr, long_cols, long_chunk_ptr, chunk_long, \
                     idx, u, s, su, partial, qp, y, n, r, d_g, k, kp,       \
                     stages, n_long, n_chunks, chunk, st)
  switch (kc) {
    case 1: return (int)GRAM_KC(1);
    case 2: return (int)GRAM_KC(2);
    case 4: return (int)GRAM_KC(4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef GRAM_KC
}
