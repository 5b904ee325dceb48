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
// the last tile) take no part at all. A query row that sees no key (a
// window, and row i >= T + window - 1) is not this kernel's: the TPU
// kernel gives it mean(V) over all T keys (every score is -1e30, so its
// softmax is uniform), and ops.flash_attention writes that mean over the
// kernel's output for those rows after the launch.
//
// Layout: q and o (B, S, H, hd), k and v (B, T, Hkv, hd), all contiguous;
// head h reads kv head h / (H / Hkv), so a grouped-query prefill needs no
// repeated copy of K and V.
//
// What bounds it on the card: operations. Causal attention at the prefill's
// shape (B 4, S = T = 4096, H 16, hd 128) is 4 * hd * S(S+1)/2 * B*H =
// 274.9 GFLOP, 0.278 ms at 989 TFLOP/s bf16, against 201 MB of Q/K/V/O,
// 0.060 ms at 3.35 TB/s. So the design keeps the tensor cores fed.
//
// Design. The TPU kernel walks a sequential grid (BH, S/bq, T/bkv) and
// carries (acc, m, l) in VMEM scratch along the kv axis. Here one block owns
// one (batch, head) and 128 query rows, and walks the K/V tiles itself;
// (acc, m, l) stay in registers. Blocks of the heaviest (last) query tiles
// are launched first.
//   - bfloat16 (TMA + wgmma, warp-specialised): 384 threads, two consumer
//     warpgroups of 64 query rows each and one producer warpgroup, of which
//     one thread issues the loads.
//       Producer: TMA loads of the Q tile once, then of the K and V tiles
//       (BC = 64 keys) into a 3-stage ring in dynamic shared memory, each
//       stage with a full barrier for K, one for V and an empty barrier.
//       The tensor maps are built on the host (cuTensorMapEncodeTiled,
//       through cudaGetDriverEntryPoint: no libcuda link) over the 4-D
//       (hd, heads, rows, batch) views, so grouped K/V is read at Hkv heads.
//       A tile is loaded as slabs of W = 64 columns with the 128-byte
//       swizzle (W = 32 and the 64-byte swizzle at hd 32 and 160, W = 16
//       and the 32-byte swizzle at hd 16). TMA clips the box at S and T and
//       fills the rows past them with zeros.
//       Consumers, for each tile j: S_j = Q K_j^T with wgmma m64n64k16,
//       both operands from shared memory (K-major), issued together with
//       O += P_{j-1} V_{j-1} (wgmma m64n<hd>k16, A = P from registers, B =
//       V from shared memory through the transpose bit, so V stays (key,
//       hd) in memory); then the online softmax of S_j on the accumulator
//       fragment: row max over the quad by shuffles, p = exp2(s * scale -
//       m * scale) in one FMA and one ex2, two partial maxima and sums per
//       row, the row sum reduced over the quad once at the end, O rescaled,
//       P packed to bf16 in registers, unnormalised. Each warp releases a
//       stage on its empty barrier once the PV product that read it is
//       done. The two warpgroups take turns (named barriers 1 and 2) to
//       issue their products, so one's softmax runs while the other's
//       products occupy the tensor cores: on the card the softmax, not the
//       products, is the longer part of a tile.
//       Registers: S 32, P 16 and O 64 (hd 128) a thread. setmaxnreg gives
//       the producer warpgroup 24 and the consumers 240, but ptxas (CUDA
//       12.9) still allocates the consumer code within the launch's own
//       bound of 168 (65,536 / 384; -Xptxas -v), so a 128-key tile (S 64 +
//       P 32 + O 64) spills and a 64-key tile does not.
//     Tiles wholly masked by causality or the window are skipped per block
//     (first live tile max(0, q0 - window + 1) / BC); only diagonal,
//     window-edge and ragged tiles evaluate the mask. Both warpgroups walk
//     the block's tiles (their turns must pair up); a tile wholly masked
//     for one warpgroup's rows adds nothing to them.
//     A wait on a barrier that lasts 10 s traps, so a pipeline fault ends
//     the launch with an error instead of hanging.
//   - float32: no TF32 (the float32 tolerance is 2e-5): plain FMA, 4 threads
//     per query row, 32 rows and 16 keys per tile, scores in registers and
//     P through shared memory.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float kMasked = -1e30f;
constexpr int kThreads = 128;  // the float32 kernel's block

__device__ __forceinline__ bool visible(int row, int col, int causal,
                                        int window) {
  if (causal && col > row) return false;
  if (window > 0 && col <= row - window) return false;
  return true;
}

// --------------------------------------------------------------------------
// bfloat16: TMA, mbarriers and wgmma (sm_90a)
// --------------------------------------------------------------------------

constexpr int kBR = 128;              // query rows per block
constexpr int kStages = 3;            // K/V ring depth
constexpr int kConsumerThreads = 256; // two warpgroups
// plus a producer warpgroup: setmaxnreg moves registers only within the
// block, so the consumers' 240 a thread must come from the 128 x 144 that
// a whole producer warpgroup gives up (168 each at launch).
constexpr int kBf16Threads = kConsumerThreads + 128;

template <int HD>
struct Tile {
  static constexpr int W = HD == 16 ? 16 : (HD == 32 || HD == 160) ? 32 : 64;
  static constexpr int kSlabs = HD / W;
  static constexpr int kRowBytes = W * 2;           // = the swizzle span
  static constexpr int kBC = 64;                    // keys per tile
  static constexpr int kQSlab = kBR * kRowBytes;
  static constexpr int kKSlab = kBC * kRowBytes;
  static constexpr int kQBytes = kQSlab * kSlabs;
  static constexpr int kKBytes = kKSlab * kSlabs;   // one K (or V) tile
  static constexpr int kSmem = kQBytes + kStages * 2 * kKBytes + 1024;
  // wgmma descriptor layout: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr uint64_t kLayout = W == 64 ? 1 : W == 32 ? 2 : 3;
  static_assert(HD % W == 0 && HD % 16 == 0, "head dim");
  static_assert(kQSlab % 1024 == 0 && kKSlab % 1024 == 0, "slab alignment");
};

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
// kernel lasts more than microseconds; one that lasts 10 s traps.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (uint32_t tries = 0;; ++tries) {
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
      if (tries == 0)
        t0 = t;
      else if (t - t0 > 10000000000ull)
        __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* tm,
                                            int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptor of wgmma: start address, leading and
// stride byte offsets (16-byte units), swizzle layout.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// Named barriers 1 and 2 between the two consumer warpgroups.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until every committed group of this warpgroup is done.
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin registers in place across the asynchronous wgmma: the compiler may
// not move reads of an accumulator between issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S (+)= A·B, A and B from shared memory (both K-major); scale_d = 0
// overwrites S.
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                         int scale_d);

// O += A·B, A from registers, B from shared memory with N contiguous
// (imm-trans-b = 1: V needs no transposed copy).
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<160>(float (&d)[80],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Online softmax of one tile in place: sc (this thread's fragment of
// S = Q K^T: sc[i] is row (i & 2 ? row1 : row0), key k0 + 8 (i / 4) +
// 2 tq + (i & 1)) becomes P = exp2(scale * (s - m)), unrounded; m0, m1
// (the running row max of the unscaled scores, quad-reduced) and this
// thread's share l0, l1 of the running row sums move on; O must be
// rescaled by (a0, a1). Only an edge tile evaluates the mask. A masked
// score weighs exactly 0 here, where the TPU kernel gives -1e30: the two
// differ only while a row has seen no visible key, and the rescale that
// its first visible key brings clears that state in the TPU kernel. Two
// partial maxima and sums per row shorten the dependency chains.
template <int BC>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[BC / 2], int k0, int row0, int row1, int T, int causal,
    int window, bool edge, float scale_log2, int tq, float& m0, float& m1,
    float& l0, float& l1, float& a0, float& a1) {
  if (edge) {
#pragma unroll
    for (int i = 0; i < BC / 2; ++i) {
      const int col = k0 + (i / 4) * 8 + tq * 2 + (i & 1);
      if (col >= T || !visible((i & 2) ? row1 : row0, col, causal, window))
        sc[i] = -INFINITY;
    }
  }
  float mx[2][2] = {{m0, m0}, {m1, m1}};  // [row][partial]
#pragma unroll
  for (int i = 0; i < BC / 2; ++i)
    mx[(i >> 1) & 1][(i >> 2) & 1] = fmaxf(mx[(i >> 1) & 1][(i >> 2) & 1],
                                           sc[i]);
  float mr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mr[r] = fmaxf(mx[r][0], mx[r][1]);
    mr[r] = fmaxf(mr[r], __shfl_xor_sync(0xffffffffu, mr[r], 1));
    mr[r] = fmaxf(mr[r], __shfl_xor_sync(0xffffffffu, mr[r], 2));
  }
  // a row that has seen no visible key yet keeps m = -inf, p = 0, alpha 1
  a0 = mr[0] == -INFINITY ? 1.f : fast_exp2((m0 - mr[0]) * scale_log2);
  a1 = mr[1] == -INFINITY ? 1.f : fast_exp2((m1 - mr[1]) * scale_log2);
  m0 = mr[0];
  m1 = mr[1];
  const float ms[2] = {mr[0] == -INFINITY ? 0.f : mr[0] * scale_log2,
                       mr[1] == -INFINITY ? 0.f : mr[1] * scale_log2};
  float rs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int i = 0; i < BC / 2; ++i) {
    const float p = fast_exp2(fmaf(sc[i], scale_log2, -ms[(i >> 1) & 1]));
    sc[i] = p;
    rs[(i >> 1) & 1][(i >> 2) & 1] += p;
  }
  l0 = l0 * a0 + (rs[0][0] + rs[0][1]);
  l1 = l1 * a1 + (rs[1][0] + rs[1][1]);
}

// P to bf16: the score fragment of keys 16kk.. is the A fragment of step kk.
template <int BC>
__device__ __forceinline__ void pack_p(const float (&sc)[BC / 2],
                                       uint32_t (&pf)[BC / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BC / 16; ++kk) {
    pf[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
    pf[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pf[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pf[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// O += P V for one tile, committed as one group: V is (key, hd) in shared
// memory at vs, read through the transpose bit.
template <int HD>
__device__ __forceinline__ void issue_pv(float (&acc)[HD / 2],
                                         const uint32_t (&pf)[Tile<HD>::kBC / 16][4],
                                         uint32_t vs) {
  using C = Tile<HD>;
#pragma unroll
  for (int kk = 0; kk < C::kBC / 16; ++kk)
    wgmma_rs<HD>(acc, pf[kk],
                 gmma_desc(vs + kk * 16 * C::kRowBytes, C::kKSlab,
                           8 * C::kRowBytes, C::kLayout));
  wgmma_commit();
}

template <int HD>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  __nv_bfloat16* __restrict__ o, int S, int T, int H,
                  int HKV, int causal, int window, float scale_log2) {
  using C = Tile<HD>;
  constexpr int BC = C::kBC;
  extern __shared__ uint8_t smem_raw[];
  // bars: Q, then full K, full V and empty for each stage
  __shared__ __align__(8) uint64_t bars[1 + 3 * kStages];
  const uint32_t q_smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = smem_u32(&bars[0]);
  auto full_k = [&](int st) { return smem_u32(&bars[1 + st]); };
  auto full_v = [&](int st) { return smem_u32(&bars[1 + kStages + st]); };
  auto empty = [&](int st) { return smem_u32(&bars[1 + 2 * kStages + st]); };
  // stage st: its K tile, then its V tile
  auto k_smem = [&](int st) {
    return q_smem + C::kQBytes + st * 2 * C::kKBytes;
  };

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int hk = h / (H / HKV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBR;
  const int n_kv = (T + BC - 1) / BC;
  const int last_row = min(q0 + kBR, S) - 1;
  const int j_end = causal ? min(n_kv, last_row / BC + 1) : n_kv;
  const int j_begin = window > 0 ? max(0, q0 - window + 1) / BC : 0;
  // warp-uniform for the compiler (a broadcast from lane 0), as each
  // role's code runs under its own setmaxnreg count
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty(st), kConsumerThreads / 32);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerThreads / 32) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == kConsumerThreads / 32 && lane == 0) {
      mbar_expect_tx(bar_q, C::kQBytes);
#pragma unroll
      for (int s = 0; s < C::kSlabs; ++s)
        tma_load_4d(q_smem + s * C::kQSlab, &tm_q, s * C::W, h, q0, b, bar_q);
      int it = 0;
      for (int j = j_begin; j < j_end; ++j, ++it) {
        const int st = it % kStages;
        const uint32_t ph = (it / kStages) & 1;
        mbar_wait(empty(st), ph ^ 1);  // the first round passes at once
        const uint32_t ks = k_smem(st), vs = ks + C::kKBytes;
        mbar_expect_tx(full_k(st), C::kKBytes);
#pragma unroll
        for (int s = 0; s < C::kSlabs; ++s)
          tma_load_4d(ks + s * C::kKSlab, &tm_k, s * C::W, hk, j * BC, b,
                      full_k(st));
        mbar_expect_tx(full_v(st), C::kKBytes);
#pragma unroll
        for (int s = 0; s < C::kSlabs; ++s)
          tma_load_4d(vs + s * C::kKSlab, &tm_v, s * C::W, hk, j * BC, b,
                      full_v(st));
      }
    }
  } else {
    // ---- two consumer warpgroups, 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = warp / 4, w4 = warp % 4;
    const int tq = lane % 4;
    const int wg_lo = q0 + wg * 64;
    const int wg_hi = min(wg_lo + 63, S - 1);
    const int row0 = wg_lo + w4 * 16 + lane / 4, row1 = row0 + 8;
    const uint32_t q_wg = q_smem + wg * 64 * C::kRowBytes;
    constexpr uint32_t kSBO = 8 * C::kRowBytes;  // next 8 rows

    // The block's tiles [j_begin, j_end) in ring order. Both warpgroups
    // walk all of them: a tile wholly masked for one warpgroup's rows adds
    // nothing to them (p = 0 after a visible key, and before one it is
    // cleared by the rescale that the first visible key brings).
    auto stage = [&](int j) { return (j - j_begin) % kStages; };
    auto phase = [&](int j) { return (uint32_t)((j - j_begin) / kStages) & 1; };
    auto release = [&](int j) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(stage(j)));  // this warp is done
    };
    auto issue_qk = [&](float (&sc)[BC / 2], int j) {
      const uint32_t ks = k_smem(stage(j));
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int slab = kk * 16 / C::W, off = (kk * 16 % C::W) * 2;
        wgmma_ss<BC>(sc,
                     gmma_desc(q_wg + slab * C::kQSlab + off, 16, kSBO,
                               C::kLayout),
                     gmma_desc(ks + slab * C::kKSlab + off, 16, kSBO,
                               C::kLayout),
                     kk > 0);
      }
      wgmma_commit();
    };
    auto edge = [&](int j) {  // does any score of tile j need the mask?
      const int k0 = j * BC;
      return (causal && k0 + BC - 1 > wg_lo) ||
             (window > 0 && k0 <= wg_hi - window) || k0 + BC > T;
    };

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    uint32_t pf[BC / 16][4];  // bf16 P of the tile before
    // Ping-pong: a warpgroup issues its products only in its turn (named
    // barrier 1 + wg), then hands the turn over, so one warpgroup's
    // softmax runs while the other's products occupy the tensor cores.
    if (wg == 1 && j_begin < j_end)
      named_arrive(1, kConsumerThreads);  // warpgroup 0 goes first
    mbar_wait(bar_q, 0);

    for (int j = j_begin; j < j_end; ++j) {
      float sc[BC / 2];
      mbar_wait(full_k(stage(j)), phase(j));
      if (j > j_begin) mbar_wait(full_v(stage(j - 1)), phase(j - 1));
      named_sync(1 + wg, kConsumerThreads);
      wgmma_fence();
      fence_regs(acc);
      fence_regs(pf);
      issue_qk(sc, j);
      if (j > j_begin)  // O += P_{j-1} V_{j-1}
        issue_pv<HD>(acc, pf, k_smem(stage(j - 1)) + C::kKBytes);
      if (wg == 0 || j + 1 < j_end) named_arrive(2 - wg, kConsumerThreads);
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(acc);
      fence_regs(pf);
      if (j > j_begin) release(j - 1);
      float a0, a1;
      softmax_tile<BC>(sc, j * BC, row0, row1, T, causal, window, edge(j),
                       scale_log2, tq, m0, m1, l0, l1, a0, a1);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= (i & 2) ? a1 : a0;
      pack_p<BC>(sc, pf);
    }
    if (j_begin < j_end) {
      const int j = j_end - 1;
      mbar_wait(full_v(stage(j)), phase(j));
      wgmma_fence();
      fence_regs(acc);
      fence_regs(pf);
      issue_pv<HD>(acc, pf, k_smem(stage(j)) + C::kKBytes);
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(pf);
      release(j);
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
    const size_t row_stride = (size_t)H * HD;
    __nv_bfloat16* ob = o + (size_t)b * S * row_stride + (size_t)h * HD;
    if (row0 < S) {
      uint32_t* dst = reinterpret_cast<uint32_t*>(ob + row0 * row_stride);
#pragma unroll
      for (int jb = 0; jb < HD / 8; ++jb)
        dst[jb * 4 + tq] = pack_bf16(acc[4 * jb] * inv0, acc[4 * jb + 1] * inv0);
    }
    if (row1 < S) {
      uint32_t* dst = reinterpret_cast<uint32_t*>(ob + row1 * row_stride);
#pragma unroll
      for (int jb = 0; jb < HD / 8; ++jb)
        dst[jb * 4 + tq] =
            pack_bf16(acc[4 * jb + 2] * inv1, acc[4 * jb + 3] * inv1);
    }
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

// --------------------------------------------------------------------------
// host side: tensor maps and launches
// --------------------------------------------------------------------------

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

// The (hd, heads, rows, batch) view of a contiguous (batch, rows, heads, hd)
// bf16 tensor, cut into boxes of (w, 1, box_rows, 1).
bool make_map(EncodeTiledFn encode, CUtensorMap* map, const void* ptr, int hd,
              int heads, int rows, int batch, int w, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)rows * heads * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)w, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = w == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : w == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int b, int s, int t, int h, int hkv, int causal,
                        int window, cudaStream_t stream) {
  using C = Tile<HD>;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!make_map(encode, &mq, q, HD, h, s, b, C::W, kBR) ||
      !make_map(encode, &mk, k, HD, hkv, t, b, C::W, C::kBC) ||
      !make_map(encode, &mv, v, HD, hkv, t, b, C::W, C::kBC))
    return cudaErrorInvalidValue;
  // cudaFuncSetAttribute acts on the calling thread's current device
  // alone: lift the limit once per head dim and device
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> smem_set[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return cudaErrorInvalidDevice;
  if (!smem_set[dev].load(std::memory_order_acquire)) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::kSmem);
    if (e != cudaSuccess) return e;
    smem_set[dev].store(true, std::memory_order_release);
  }
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)HD);
  const dim3 grid((unsigned)(b * h), (unsigned)((s + kBR - 1) / kBR));
  flash_bf16_kernel<HD><<<grid, kBf16Threads, C::kSmem, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)o, s, t, h, hkv, causal, window,
      scale_log2);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o,
                      int b, int s, int t, int h, int hkv, int causal,
                      int window, int is_bf16, cudaStream_t stream) {
  if (is_bf16)
    return launch_bf16<HD>(q, k, v, o, b, s, t, h, hkv, causal, window,
                           stream);
  const float scale = 1.f / sqrtf((float)HD);
  const dim3 grid((unsigned)(b * h), (unsigned)((s + kBR32 - 1) / kBR32));
  flash_f32_kernel<HD><<<grid, kThreads, 0, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, s, t, h,
      hkv, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q, o: (b, s, h, hd); k, v: (b, t, hkv, hd); contiguous, 16-byte aligned.
// window <= 0 means no window. Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for a head dim without an instantiation (or a
// shape no tensor map takes), cudaErrorNotSupported if the driver has no
// cuTensorMapEncodeTiled.
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
