// Flash attention (forward) for Hopper: online-softmax attention whose
// (S x T) scores and probabilities never reach device memory.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas
// (_flash_kernel), the TPU kernel of the LM stack's prefill.
//
// What it computes, for every (batch, head) and query row i:
//   s_ij = scale * q_i . k_j            scale = 1/sqrt(hd), float32
//   s_ij = -1e30 where masked           causal: j > i; window: j <= i - window
//   o_i  = sum_j p_ij v_j / max(l_i, 1e-30),  p_ij = exp(s_ij - m_i)
// with the running max m and sum l in float32 (online softmax), and p cast
// to V's dtype before the PV product, as the TPU kernel's
// p.astype(v.dtype) does. Positions count from 0 for both q and kv (top-
// left alignment, as in the TPU kernel). Keys at j >= T (the ragged edge of
// the last tile) take no part at all. A query row that sees no key is
// outside the contract (the TPU kernel's rows always see one).
//
// Layout: q and o (B, S, H, hd), k and v (B, T, Hkv, hd), all contiguous;
// head h reads kv head h / (H / Hkv), so a grouped-query prefill needs no
// repeated copy of K and V.
//
// What bounds it on the card: operations. Causal attention at the prefill's
// shape (B 4, S = T = 4096, H 16, hd 128) is 4 * hd * S(S+1)/2 * B*H =
// 274.9 GFLOP, 0.278 ms at 989 TFLOP/s bf16, against 268 MB of Q/K/V/O,
// 0.080 ms at 3.35 TB/s.
//
// Design. The TPU kernel walks a sequential grid (BH, S/bq, T/bkv) and
// carries (acc, m, l) in VMEM scratch along the kv axis. Here one block owns
// one (batch, head) and a tile of query rows, and a loop inside the block
// walks the K/V tiles, staged in shared memory; (acc, m, l) stay in
// registers. Tiles wholly masked by causality or the window are skipped for
// the block, and per warp for the rows it owns. Blocks of the heaviest
// (last) query tiles are launched first.
//   - bfloat16: 4 warps x 16 query rows, 64-key tiles; QK^T and PV on the
//     tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate). The
//     score fragment of QK^T is, register for register, the A fragment of
//     PV, so P goes from the accumulator to bf16 without shared memory.
//     Shared-memory rows are padded by 16 bytes, so the fragment loads hit
//     32 distinct banks.
//   - float32: no TF32 (the float32 tolerance is 2e-5): plain FMA, 4 threads
//     per query row, 32 rows and 16 keys per tile, scores in registers and
//     P through shared memory.
// Not yet used: TMA, wgmma, cp.async pipelining, warp specialisation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e30f;

__device__ __forceinline__ bool visible(int row, int col, int causal,
                                        int window) {
  if (causal && col > row) return false;
  if (window > 0 && col <= row - window) return false;
  return true;
}

// --------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync)
// --------------------------------------------------------------------------

constexpr int kBR = 64;       // query rows per block (16 per warp)
constexpr int kBC = 64;       // keys per tile
constexpr int kThreads = 128;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// rows [r0, r0 + 64) of a (rows, stride) bf16 matrix into a padded tile;
// rows at or past n_rows are zero.
template <int HD>
__device__ __forceinline__ void load_tile(uint16_t (*dst)[HD + 8],
                                          const uint16_t* src, long stride,
                                          int r0, int n_rows) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kBC * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(src + (long)(r0 + r) * stride +
                                            c * 8);
    *reinterpret_cast<uint4*>(&dst[r][c * 8]) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bf16_kernel(const uint16_t* __restrict__ q,
                  const uint16_t* __restrict__ k,
                  const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
                  int S, int T, int H, int HKV, int causal, int window,
                  float scale) {
  constexpr int LD = HD + 8;
  __shared__ __align__(16) uint16_t ks[kBC][LD];
  __shared__ __align__(16) uint16_t vs[kBC][LD];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / HKV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const long q_stride = (long)H * HD, kv_stride = (long)HKV * HD;
  const uint16_t* qb = q + (long)b * S * q_stride + (long)h * HD;
  const uint16_t* kb = k + (long)b * T * kv_stride + (long)hk * HD;
  const uint16_t* vb = v + (long)b * T * kv_stride + (long)hk * HD;
  uint16_t* ob = o + (long)b * S * q_stride + (long)h * HD;

  // Q tile through the K buffer into registers, as A fragments.
  load_tile<HD>(ks, qb, q_stride, q0, S);
  __syncthreads();
  const int wr = warp * 16;
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk * 16 + tq * 2;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(&ks[wr + g][c]);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(&ks[wr + g + 8][c]);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(&ks[wr + g][c + 8]);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(&ks[wr + g + 8][c + 8]);
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m_run[2] = {kMasked, kMasked}, l_run[2] = {0.f, 0.f};
  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};
  const int w_lo = q0 + wr, w_hi = w_lo + 15;  // this warp's query rows

  const int n_kv = (T + kBC - 1) / kBC;
  int j_end = n_kv;
  if (causal) j_end = min(n_kv, (q0 + kBR - 1) / kBC + 1);
  const int j_begin = window > 0 ? max(0, q0 - window + 1) / kBC : 0;

  for (int j = j_begin; j < j_end; ++j) {
    const int k0 = j * kBC;
    __syncthreads();  // every warp is done with the previous tile
    load_tile<HD>(ks, kb, kv_stride, k0, T);
    load_tile<HD>(vs, vb, kv_stride, k0, T);
    __syncthreads();
    if (w_lo >= S) continue;
    if (causal && k0 > w_hi) continue;
    if (window > 0 && k0 + kBC - 1 <= w_lo - window) continue;

    // S = Q K^T for this warp's 16 rows x 64 keys
    float sc[kBC / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBC / 8; ++nt)
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kBC / 8; ++nt) {
        const uint16_t* kp = &ks[nt * 8 + g][kk * 16 + tq * 2];
        mma_bf16(sc[nt], qf[kk], *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }

    // scale, mask, online softmax (rows g and g + 8 of the warp's 16)
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < kBC / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + tq * 2 + (e & 1);
        float s = sc[nt][e] * scale;
        if (col >= T)
          s = -INFINITY;
        else if (!visible(row[e >> 1], col, causal, window))
          s = kMasked;
        sc[nt][e] = s;
        mx[e >> 1] = fmaxf(mx[e >> 1], s);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = __expf(m_run[i] - mx[i]);
      m_run[i] = mx[i];
    }
#pragma unroll
    for (int nt = 0; nt < kBC / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(sc[nt][e] - mx[e >> 1]);
        sc[nt][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l_run[i] = l_run[i] * alpha[i] + rs[i];
    }
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // O += bf16(P) V: score tiles 2kk, 2kk+1 are the A fragment of step kk
#pragma unroll
    for (int kk = 0; kk < kBC / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_f32(sc[2 * kk][0], sc[2 * kk][1]);
      pa[1] = pack_f32(sc[2 * kk][2], sc[2 * kk][3]);
      pa[2] = pack_f32(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[3] = pack_f32(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        const uint16_t* vp = &vs[kk * 16 + tq * 2][dt * 8 + g];
        mma_bf16(acc[dt], pa, pack_raw(vp[0], vp[LD]),
                 pack_raw(vp[8 * LD], vp[9 * LD]));
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) inv[i] = 1.f / fmaxf(l_run[i], 1e-30f);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= S) continue;
    uint16_t* orow = ob + (long)row[i] * q_stride;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + tq * 2) =
          pack_f32(acc[dt][2 * i] * inv[i], acc[dt][2 * i + 1] * inv[i]);
  }
}

// --------------------------------------------------------------------------
// float32: FMA, no tensor cores
// --------------------------------------------------------------------------

constexpr int kBR32 = 32;     // query rows per block (8 per warp)
constexpr int kBC32 = 16;     // keys per tile
constexpr int kPerRow = 4;    // threads per query row

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int T, int H, int HKV, int causal, int window, float scale) {
  __shared__ float qs[kBR32][HD + 1];
  __shared__ float ks[kBC32][HD + 1];
  __shared__ float vs[kBC32][HD];
  __shared__ float ps[kBR32][kBC32 + 1];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / HKV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBR32;
  const int r = threadIdx.x / kPerRow, c4 = threadIdx.x % kPerRow;
  const int row = q0 + r;
  const long q_stride = (long)H * HD, kv_stride = (long)HKV * HD;
  const float* qb = q + (long)b * S * q_stride + (long)h * HD;
  const float* kb = k + (long)b * T * kv_stride + (long)hk * HD;
  const float* vb = v + (long)b * T * kv_stride + (long)hk * HD;

  for (int i = threadIdx.x; i < kBR32 * HD; i += kThreads) {
    const int rr = i / HD, d = i % HD;
    qs[rr][d] = q0 + rr < S ? qb[(long)(q0 + rr) * q_stride + d] : 0.f;
  }

  constexpr int kD = HD / kPerRow;  // output columns per thread
  float acc[kD];
#pragma unroll
  for (int jd = 0; jd < kD; ++jd) acc[jd] = 0.f;
  float m_run = kMasked, l_run = 0.f;
  const int w_lo = q0 + (threadIdx.x / 32) * (32 / kPerRow);
  const int w_hi = w_lo + 32 / kPerRow - 1;

  const int n_kv = (T + kBC32 - 1) / kBC32;
  int j_end = n_kv;
  if (causal) j_end = min(n_kv, (q0 + kBR32 - 1) / kBC32 + 1);
  const int j_begin = window > 0 ? max(0, q0 - window + 1) / kBC32 : 0;

  for (int j = j_begin; j < j_end; ++j) {
    const int k0 = j * kBC32;
    __syncthreads();
    for (int i = threadIdx.x; i < kBC32 * HD; i += kThreads) {
      const int rr = i / HD, d = i % HD;
      const bool in = k0 + rr < T;
      ks[rr][d] = in ? kb[(long)(k0 + rr) * kv_stride + d] : 0.f;
      vs[rr][d] = in ? vb[(long)(k0 + rr) * kv_stride + d] : 0.f;
    }
    __syncthreads();
    if (w_lo >= S) continue;
    if (causal && k0 > w_hi) continue;
    if (window > 0 && k0 + kBC32 - 1 <= w_lo - window) continue;

    float s[kBC32 / kPerRow];
    float mx = m_run;
#pragma unroll
    for (int jc = 0; jc < kBC32 / kPerRow; ++jc) {
      const int c = c4 + kPerRow * jc;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) dot = fmaf(qs[r][d], ks[c][d], dot);
      float sv = dot * scale;
      if (k0 + c >= T)
        sv = -INFINITY;
      else if (!visible(row, k0 + c, causal, window))
        sv = kMasked;
      s[jc] = sv;
      mx = fmaxf(mx, sv);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float alpha = expf(m_run - mx);
    m_run = mx;
    float rs = 0.f;
#pragma unroll
    for (int jc = 0; jc < kBC32 / kPerRow; ++jc) {
      const float p = expf(s[jc] - mx);
      ps[r][c4 + kPerRow * jc] = p;
      rs += p;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l_run = l_run * alpha + rs;
    __syncwarp();
#pragma unroll
    for (int jd = 0; jd < kD; ++jd) {
      const int d = c4 + kPerRow * jd;
      float pv = 0.f;
#pragma unroll
      for (int c = 0; c < kBC32; ++c) pv = fmaf(ps[r][c], vs[c][d], pv);
      acc[jd] = acc[jd] * alpha + pv;
    }
    __syncwarp();
  }

  if (row >= S) return;
  float* orow = o + (long)b * S * q_stride + (long)row * q_stride +
                (long)h * HD;
  const float denom = fmaxf(l_run, 1e-30f);
#pragma unroll
  for (int jd = 0; jd < kD; ++jd) orow[c4 + kPerRow * jd] = acc[jd] / denom;
}

template <int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o,
                      int b, int s, int t, int h, int hkv, int causal,
                      int window, int is_bf16, cudaStream_t stream) {
  const float scale = 1.f / sqrtf((float)HD);
  if (is_bf16) {
    const dim3 grid((unsigned)(b * h), (unsigned)((s + kBR - 1) / kBR));
    flash_bf16_kernel<HD><<<grid, kThreads, 0, stream>>>(
        (const uint16_t*)q, (const uint16_t*)k, (const uint16_t*)v,
        (uint16_t*)o, s, t, h, hkv, causal, window, scale);
  } else {
    const dim3 grid((unsigned)(b * h), (unsigned)((s + kBR32 - 1) / kBR32));
    flash_f32_kernel<HD><<<grid, kThreads, 0, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, s, t, h,
        hkv, causal, window, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// q, o: (b, s, h, hd); k, v: (b, t, hkv, hd); contiguous, 16-byte aligned.
// window <= 0 means no window. Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for a head dim without an instantiation.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int s,
                                      int t, int h, int hkv, int hd,
                                      int causal, int window, int is_bf16,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 16:
      return (int)launch_hd<16>(q, k, v, o, b, s, t, h, hkv, causal, window,
                                is_bf16, st);
    case 32:
      return (int)launch_hd<32>(q, k, v, o, b, s, t, h, hkv, causal, window,
                                is_bf16, st);
    case 64:
      return (int)launch_hd<64>(q, k, v, o, b, s, t, h, hkv, causal, window,
                                is_bf16, st);
    case 128:
      return (int)launch_hd<128>(q, k, v, o, b, s, t, h, hkv, causal, window,
                                 is_bf16, st);
    case 160:
      return (int)launch_hd<160>(q, k, v, o, b, s, t, h, hkv, causal, window,
                                 is_bf16, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
