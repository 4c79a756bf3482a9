// K7: the dot chain of the matrix-unit probe, by operand type.
//
// Replaces scripts/bench_mxu_dtypes.py::main.make.kern (the pl.pallas_call at
// :51), the TPU probe that times the BSR routing tile (128 x 128 @ 128 x S) on
// the matrix unit.  Same function, computed by
// experiments/bench_mxu_dtypes.py::dot_chain_plain, this kernel's plain
// version: a (1024, 128) and b (8192, S) of one type (bf16, f32 or int8), out
// (128, S) f32.  Step i of chain/8 adds, for j = 0..7, the dot
// a_j @ b_k cast to f32 to accumulator j, where a_j = a[128 j : 128 j + 128],
// k = (i + 8 j) mod 64 and b_k = b[128 k : 128 k + 128]; the output is
// acc_0 + acc_1 + ... + acc_7 in that order.
//
// What bounds it on an H100: operations.  A dot is 2 * 128 * 128 * S of them
// against a and b read once (a and b, 0.4-4 MB, stay in the 50 MB L2): bf16
// at 989.4 TFLOP/s and int8 at 1,978.9 TOP/s on the tensor cores, f32 at
// 67 TFLOP/s on the CUDA cores (utils/bounds.py::dot_chain_bound).  Behind
// the operations, the L2: a block multiplies its a_j by a new b tile every
// dot (32 KB bf16, 16 KB int8, 64 KB f32 at S = 128), ~7.7 TB/s of L2 reads
// over the card at the tensor cores' peak.
//
// Design.  The TPU kernel holds a and b in VMEM and runs the whole chain on
// its one core.  Here the chain's 8 * chain/8 dots, accumulator by
// accumulator, are split evenly over B blocks a column tile, one an SM
// (experiments/bench_mxu_dtypes.py::dot_chain_plan, B >= 8, so a block's
// range meets at most two accumulators: one partial each); each block sums
// its dots of an accumulator from zero into a (128, 128) partial, and a
// second small grid adds the partials in a fixed order: each accumulator's
// blocks in order (the eight accumulators at once, a warp each), then
// accumulators 0..7 in order (as the TPU kernel adds its accumulators), so
// the output is the same on every run.  Each product
// passes through at most 128 + chain/8 + parts + 8 roundings (parts: the
// most blocks that share one accumulator), the depth dot_chain_tolerance
// allows.
//
// A block is warp-specialized: one producer thread keeps TMA loads
// (cp.async.bulk.tensor) of b tiles in flight into a ring of shared-memory
// stages guarded by full and empty mbarriers (no block-wide barrier in the
// loop), and two consumer warpgroups each own 64 rows of the 128 x 128 tile,
// with the registers the producer's warpgroup gives up (setmaxnreg).  The
// waits and the stage releases are single asm statements, so the loops that
// issue wgmma have no branch of their own and ptxas keeps them asynchronous.
//   bf16: wgmma.mma_async m64n128k16 f32.bf16.bf16; A = a_j, K-major, B = the
//     b tile as it lies ([k][n], the transpose flag set), both in 128-byte
//     swizzled layouts that TMA writes and the descriptors name.  Every dot
//     starts from zero in its own f32 registers and is then added to the
//     partial's f32 sum, as the TPU kernel casts each dot and adds it; two
//     dot buffers, so that the add of one dot overlaps the next dot's wgmma.
//   int8: wgmma.mma_async m64n128k32 s32.s8.s8.  8-bit wgmma takes both
//     operands K-major, so b comes with each tile transposed, (64, S, 128)
//     (experiments/bench_mxu_dtypes.py::b_tiles_nk, laid out once per operand
//     set).  The dots fold into one int32 sum a partial (exact: a dot is at
//     most 128 * 4 * 4 = 2,048 in magnitude for the probe's operands in
//     [-4, 4], so no overflow below 2^20 dots a partial), converted once to
//     f32.  That equals the TPU kernel's per-dot f32 sums wherever every
//     partial sum stays below 2^24 in magnitude, which holds for every chain
//     below 65,536 (chain/8 * 2,048 < 2^24) and in practice far beyond.
//   f32: FFMA on the CUDA cores (TF32 tensor cores would round the operands
//     to 10 bits: another function), fed by the same TMA ring, a thread an
//     8 x 8 register tile with the next k's operands loaded ahead, a_j held
//     transposed in shared memory; each dot starts from zero, one fused
//     multiply-add per product in k order.
// Thread-block clusters that read each b tile from L2 once for 2 or 4 blocks
// (multicast TMA) were measured and do not pay at this tile (PERF.md, Findings).
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;                 // operand tiles are 128 x 128; a block owns 128 columns
constexpr int CONSUMERS = 256;            // two warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and the producer's warpgroup (one thread works)
// registers a thread after the split (setmaxnreg): 2 x 128 x 232 + 128 x 40 <= 65,536
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;
constexpr int NACC = 8;                   // accumulators of the chain
constexpr int NTILES = 64;                // b tiles
enum { DT_BF16 = 0, DT_F32 = 1, DT_INT8 = 2 };

// Ring stages, bytes of a b tile, bytes of the a region (bf16 / int8: the two
// a_j tiles a block may need; f32: one a_j transposed, reloaded between its
// two partials), and the arrivals that free a stage (a warpgroup's one thread
// after its wgmma completed; for f32 each consumer warp).
template <int DT> struct Cfg;
template <> struct Cfg<DT_BF16> {
  static constexpr int RING = 5, STAGE = TILE * TILE * 2, ABYTES = 2 * STAGE, EMPTY = 2;
};
template <> struct Cfg<DT_INT8> {
  static constexpr int RING = 8, STAGE = TILE * TILE, ABYTES = 2 * STAGE, EMPTY = 2;
};
template <> struct Cfg<DT_F32> {
  static constexpr int RING = 2, STAGE = TILE * TILE * 4, ABYTES = STAGE, EMPTY = 8;
};

// 1 KB to align the swizzled regions, a, the ring, full / empty / a barriers
template <int DT>
constexpr int smem_bytes() {
  return 1024 + Cfg<DT>::ABYTES + Cfg<DT>::RING * Cfg<DT>::STAGE + (2 * Cfg<DT>::RING + 1) * 8;
}

// ---- PTX helpers --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait for the phase of parity `parity` to complete, the loop inside one asm
// statement.  A wait that lasts ~2^33 clocks is a fault of the kernel (a
// producer and its consumers that disagree on the dots): it traps, so the
// call fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n .reg .u64 t0, t1;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n @p bra K7_DONE;\n"
      " mov.u64 t0, %%clock64;\n"
      "K7_WAIT:\n mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n @p bra K7_DONE;\n"
      " mov.u64 t1, %%clock64;\n sub.u64 t1, t1, t0;\n setp.lt.u64 p, t1, %2;\n"
      " @p bra K7_WAIT;\n trap;\n"
      "K7_DONE:\n}\n" ::"r"(bar),
      "r"(parity), "l"(1ull << 33)
      : "memory");
}

// Arrive on `bar` where `pred` (predicated: no branch).
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %1, 0;\n"
      " @p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"((int)pred)
      : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void consumers_sync() {   // the 256 consumer threads
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// One TMA box to shared memory at `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* tm, uint32_t bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)tm), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte swizzled operand at `addr`
// (1 KB-aligned swizzle atoms of 8 rows x 128 bytes): lbo / sbo in bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator registers across an async wgmma.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define K7_F8(d, i)                                                                       \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),        \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define K7_R8(d, i)                                                                       \
  "+r"(d[i + 0]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]),        \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define K7_REGS                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "               \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "      \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "      \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d = (scale_d ? d : 0) + A B: A 64 x 16 K-major, B 16 x 128 MN-major (trans-b 1)
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " K7_REGS
      ", %64, %65, p, 1, 1, 0, 1;\n}\n"
      : K7_F8(d, 0), K7_F8(d, 8), K7_F8(d, 16), K7_F8(d, 24), K7_F8(d, 32), K7_F8(d, 40),
        K7_F8(d, 48), K7_F8(d, 56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B: A 64 x 32 and B 32 x 128, both K-major, s8 -> s32
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " K7_REGS ", %64, %65, p;\n}\n"
      : K7_R8(d, 0), K7_R8(d, 8), K7_R8(d, 16), K7_R8(d, 24), K7_R8(d, 32), K7_R8(d, 40),
        K7_R8(d, 48), K7_R8(d, 56)
      : "l"(da), "l"(db), "r"(1));
}

// One bf16 dot of the warpgroup's 64 rows into d, from zero: A (a_j's rows, at
// `a`: the two 64-k halves 16 KB apart, a k16 slice 32 bytes on), B (the stage
// at `b`: its two 64-column halves 16 KB apart (LBO), 8 k rows 1 KB apart
// (SBO), a k16 slice 2 KB on).
__device__ __forceinline__ void bf16_dot(float (&d)[64], uint32_t a, uint32_t b) {
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_bf16(d, sw128_desc(a + (kk / 4) * (TILE * 128) + (kk % 4) * 32, 16, 1024),
               sw128_desc(b + kk * 2048, TILE * 128, 1024), kk > 0);
  wgmma_commit();
}

// One int8 dot added into d: A and B K-major 128-byte rows, a k32 slice 32 bytes on.
__device__ __forceinline__ void s8_dot(int (&d)[64], uint32_t a, uint32_t b) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_s8(d, sw128_desc(a + kk * 32, 16, 1024), sw128_desc(b + kk * 32, 16, 1024));
  wgmma_commit();
}

__device__ __forceinline__ void add64(float (&sum)[64], const float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) sum[i] += d[i];
}

// Stores a 64 x 128 wgmma accumulator (rows 64 wg ..) of a partial tile.
template <typename T>
__device__ __forceinline__ void store_frag(float* out, int S, const T (&v)[64]) {
  const int lane = threadIdx.x % 32, warp4 = (threadIdx.x / 32) % 4, wg = threadIdx.x / 128;
  float* o = out + (size_t)(64 * wg + 16 * warp4 + lane / 4) * S + 2 * (lane % 4);
#pragma unroll
  for (int c8 = 0; c8 < 16; ++c8)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(o + (size_t)(8 * h) * S + 8 * c8) =
          make_float2((float)v[4 * c8 + 2 * h], (float)v[4 * c8 + 2 * h + 1]);
}

// The ring as each role walks it: the k-th dot uses stage k mod RING, the
// phase of parity (k / RING) mod 2.
template <int RING>
struct Ring {
  int stage = 0, phase = 0;
  __device__ __forceinline__ void next() {
    if (++stage == RING) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// Block b of B takes the dots [D b / B, D (b + 1) / B) of the chain's D = 8 steps,
// dot q being step q mod steps of accumulator q / steps: one or two partials
// (the second from accumulator j0 + 1's first step on).
struct Range {
  long long q0, q1, e0;   // e0: where the first partial ends
  int j0, parts;
  __device__ Range(int steps, int B, int b) {
    const long long D = (long long)NACC * steps;
    q0 = D * b / B;
    q1 = D * (b + 1) / B;
    j0 = steps > 0 ? (int)(q0 / steps) : 0;
    e0 = q1 < (long long)(j0 + 1) * steps ? q1 : (long long)(j0 + 1) * steps;
    parts = q0 >= q1 ? 0 : (e0 < q1 ? 2 : 1);
  }
  __device__ int count(int part) const { return (int)(part == 0 ? e0 - q0 : q1 - e0); }
};

template <int DT>
__global__ void __launch_bounds__(THREADS, 1)
dot_chain_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
                 const float* __restrict__ a32, float* __restrict__ part, int S, int steps, int B) {
  using K = Cfg<DT>;
  extern __shared__ __align__(16) char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw), base = (raw + 1023) & ~1023u;
  char* const gen = smem_raw + (base - raw);   // generic pointer to `base`
  const uint32_t sA = base, sB = base + K::ABYTES, bars = sB + K::RING * K::STAGE;
  const uint32_t abar = bars + 16 * K::RING;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (K::RING + s); };

  const int b = blockIdx.x, n0 = blockIdx.y * TILE;
  const Range rg(steps, B, b);

  if (threadIdx.x == 0) {
    for (int s = 0; s < K::RING; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), K::EMPTY);
    }
    mbar_init(abar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The roles split here and never meet again (setmaxnreg needs that).
  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: the a_j tiles, then every dot's b tile into the ring
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) {
      if constexpr (DT != DT_F32) {
        mbar_expect_tx(abar, rg.parts * K::STAGE);
        for (int h = 0; h < rg.parts; ++h) {
          const int j = rg.j0 + h;
          const uint32_t dst = sA + h * K::STAGE;
          if constexpr (DT == DT_BF16) {   // two boxes of 64 k x 128 rows, [m][64 k] swizzled
            tma_load(dst, &tm_a, abar, 0, j * TILE);
            tma_load(dst + TILE * 128, &tm_a, abar, 64, j * TILE);
          } else {   // one box of 128 k bytes x 128 rows, swizzled
            tma_load(dst, &tm_a, abar, 0, j * TILE);
          }
        }
      }
      Ring<K::RING> r;
      for (long long q = rg.q0; q < rg.q1; ++q) {
        const int j = (int)(q / steps), i = (int)(q - (long long)j * steps);
        const int tile = (i + NACC * j) % NTILES;
        mbar_wait(empty(r.stage), r.phase ^ 1);
        mbar_expect_tx(full(r.stage), K::STAGE);
        const uint32_t dst = sB + r.stage * K::STAGE;
        if constexpr (DT == DT_BF16) {   // two boxes of 64 columns x 128 k rows, [k][64 n]
          tma_load(dst, &tm_b, full(r.stage), n0, tile * TILE);
          tma_load(dst + TILE * 128, &tm_b, full(r.stage), n0 + 64, tile * TILE);
        } else if constexpr (DT == DT_INT8) {   // 128 n rows x 128 k bytes, [n][k]
          tma_load(dst, &tm_b, full(r.stage), 0, tile * S + n0);
        } else {   // 128 k rows x 128 columns, [k][n] plain
          tma_load(dst, &tm_b, full(r.stage), n0, tile * TILE);
        }
        r.next();
      }
    }
  } else {
    // ---- consumers: partial h of the block into part[2 b + h]
    setmaxnreg_inc<CONSUMER_REGS>();
    Ring<K::RING> r;
    auto release = [&](int s) {
      if constexpr (DT == DT_F32) {   // every warp has read the stage
        __syncwarp();
        mbar_arrive_if(empty(s), threadIdx.x % 32 == 0);
      } else {   // the warpgroup's wgmma has completed
        mbar_arrive_if(empty(s), threadIdx.x % 128 == 0);
      }
    };
    auto out_of = [&](int h) { return part + (size_t)(2 * b + h) * TILE * S + n0; };
    const int nparts = rg.parts > 0 ? rg.parts : 1;   // an empty chain stores zeros
    if constexpr (DT == DT_BF16) {
      // two dots in flight: while one runs, the one before is added to the sum
      float sum[64], d0[64], d1[64];
      mbar_wait(abar, 0);
#pragma unroll 1
      for (int h = 0; h < nparts; ++h) {
        const uint32_t aw = sA + h * K::STAGE + (threadIdx.x / 128) * 8192;   // the WG's rows
        const int n = rg.count(h);
#pragma unroll
        for (int i = 0; i < 64; ++i) sum[i] = 0.0f;
        if (n > 0) {
          mbar_wait(full(r.stage), r.phase);
          bf16_dot(d0, aw, sB + r.stage * K::STAGE);
          int prev = r.stage;
          r.next();
          int t = 1;
          for (; t + 1 < n; t += 2) {   // dots t (d1) and t + 1 (d0)
            mbar_wait(full(r.stage), r.phase);
            bf16_dot(d1, aw, sB + r.stage * K::STAGE);
            wgmma_wait<1>();
            fence_regs(d0);
            add64(sum, d0);
            release(prev);
            prev = r.stage;
            r.next();
            mbar_wait(full(r.stage), r.phase);
            bf16_dot(d0, aw, sB + r.stage * K::STAGE);
            wgmma_wait<1>();
            fence_regs(d1);
            add64(sum, d1);
            release(prev);
            prev = r.stage;
            r.next();
          }
          if (t < n) {   // the last dot, t, into d1
            mbar_wait(full(r.stage), r.phase);
            bf16_dot(d1, aw, sB + r.stage * K::STAGE);
            wgmma_wait<1>();
            fence_regs(d0);
            add64(sum, d0);
            release(prev);
            prev = r.stage;
            r.next();
            wgmma_wait<0>();
            fence_regs(d1);
            add64(sum, d1);
          } else {
            wgmma_wait<0>();
            fence_regs(d0);
            add64(sum, d0);
          }
          release(prev);
        }
        store_frag(out_of(h), S, sum);
      }
    } else if constexpr (DT == DT_INT8) {
      // exact int32 sums: a partial's dots fold into one accumulator, one dot
      // in flight behind the one issued
      int acc[64];
      mbar_wait(abar, 0);
#pragma unroll 1
      for (int h = 0; h < nparts; ++h) {
        const uint32_t aw = sA + h * K::STAGE + (threadIdx.x / 128) * 8192;
        const int n = rg.count(h);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0;
        fence_regs(acc);
        if (n > 0) {
          mbar_wait(full(r.stage), r.phase);
          s8_dot(acc, aw, sB + r.stage * K::STAGE);
          int prev = r.stage;
          r.next();
          for (int t = 1; t < n; ++t) {
            mbar_wait(full(r.stage), r.phase);
            s8_dot(acc, aw, sB + r.stage * K::STAGE);
            wgmma_wait<1>();   // the previous dot is done with its stage
            release(prev);
            prev = r.stage;
            r.next();
          }
          wgmma_wait<0>();
          release(prev);
        }
        fence_regs(acc);
        store_frag(out_of(h), S, acc);
      }
    } else {
      // f32: thread (ty, tx) of 16 x 16 owns rows {4 ty .., 64 + 4 ty ..} and
      // columns {4 tx .., 64 + 4 tx ..}; a_j transposed to At [k][m]
      float* At = reinterpret_cast<float*>(gen);
      const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
      const float* Ap = At + ty * 4;
#pragma unroll 1
      for (int h = 0; h < nparts; ++h) {
        if (h > 0) consumers_sync();   // every warp is done with the previous a_j
        const float* aj = a32 + (size_t)(rg.j0 + h) * TILE * TILE;
        // all 16 loads of a thread in flight at once
#pragma unroll
        for (int it = 0; it < TILE * TILE / 4 / CONSUMERS; ++it) {
          const int e = threadIdx.x + it * CONSUMERS;
          const int m = e % TILE, k4 = (e / TILE) * 4;   // consecutive threads, consecutive m
          const float4 v = *reinterpret_cast<const float4*>(aj + m * TILE + k4);
          At[(k4 + 0) * TILE + m] = v.x;
          At[(k4 + 1) * TILE + m] = v.y;
          At[(k4 + 2) * TILE + m] = v.z;
          At[(k4 + 3) * TILE + m] = v.w;
        }
        consumers_sync();
        const int n = rg.count(h);
        float acc[8][8];
#pragma unroll
        for (int y = 0; y < 8; ++y)
#pragma unroll
          for (int x = 0; x < 8; ++x) acc[y][x] = 0.0f;
        for (int t = 0; t < n; ++t) {
          mbar_wait(full(r.stage), r.phase);
          const float* Bp =
              reinterpret_cast<const float*>(gen + K::ABYTES + r.stage * K::STAGE) + tx * 4;
          float dot[8][8];
#pragma unroll
          for (int y = 0; y < 8; ++y)
#pragma unroll
            for (int x = 0; x < 8; ++x) dot[y][x] = 0.0f;
          float4 a0 = *reinterpret_cast<const float4*>(Ap);
          float4 a1 = *reinterpret_cast<const float4*>(Ap + 64);
          float4 b0 = *reinterpret_cast<const float4*>(Bp);
          float4 b1 = *reinterpret_cast<const float4*>(Bp + 64);
#pragma unroll 16
          for (int k = 0; k < TILE; ++k) {
            // the next k's operands (k = 127 reloads row 0: harmless)
            const int kn = (k + 1) & (TILE - 1);
            const float4 na0 = *reinterpret_cast<const float4*>(Ap + kn * TILE);
            const float4 na1 = *reinterpret_cast<const float4*>(Ap + kn * TILE + 64);
            const float4 nb0 = *reinterpret_cast<const float4*>(Bp + kn * TILE);
            const float4 nb1 = *reinterpret_cast<const float4*>(Bp + kn * TILE + 64);
            const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int y = 0; y < 8; ++y)
#pragma unroll
              for (int x = 0; x < 8; ++x) dot[y][x] = __fmaf_rn(av[y], bv[x], dot[y][x]);
            a0 = na0;
            a1 = na1;
            b0 = nb0;
            b1 = nb1;
          }
          release(r.stage);
          r.next();
#pragma unroll
          for (int y = 0; y < 8; ++y)
#pragma unroll
            for (int x = 0; x < 8; ++x) acc[y][x] += dot[y][x];
        }
        float* out = out_of(h);
#pragma unroll
        for (int y = 0; y < 8; ++y) {
          const int row = (y < 4 ? 0 : 64) + ty * 4 + (y & 3);
#pragma unroll
          for (int x = 0; x < 2; ++x)
            *reinterpret_cast<float4*>(out + (size_t)row * S + x * 64 + tx * 4) =
                make_float4(acc[y][4 * x], acc[y][4 * x + 1], acc[y][4 * x + 2],
                            acc[y][4 * x + 3]);
        }
      }
    }
  }
}

// ---- the fixed-order sum of the partials: acc_j = ((0 + p_j0) + p_j1) + ...,
// accumulator j's partials in block order, then out = ((0 + acc_0) + acc_1) +
// ... + acc_7.  Block b's partials are part[2 b] (accumulator j0(b)) and
// part[2 b + 1] (j0(b) + 1, where its range meets a second one).  A block of
// this grid owns SUM_COLS float4 columns of the output: its warp j sums
// accumulator j's partials (their loads issued SUM_BATCH at a time), and warp
// 0 adds the eight sums in order.
constexpr int SUM_COLS = 32, SUM_THREADS = NACC * SUM_COLS, SUM_BATCH = 8, MAX_BLOCKS = 1024;

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

__global__ void __launch_bounds__(SUM_THREADS)
dot_chain_sum_kernel(const float4* __restrict__ part, float4* __restrict__ out, int n4, int steps,
                     int B) {
  __shared__ signed char j0_of[MAX_BLOCKS];   // block b's first accumulator, -1: no dots
  __shared__ int first[NACC], last[NACC];      // the blocks that meet accumulator j
  __shared__ float4 sums[NACC][SUM_COLS];
  if (threadIdx.x < NACC) {
    first[threadIdx.x] = B;
    last[threadIdx.x] = -1;
  }
  __syncthreads();
  const long long D = (long long)NACC * steps;
  for (int t = threadIdx.x; t < B; t += SUM_THREADS) {
    const long long q0 = D * t / B, q1 = D * (t + 1) / B;
    j0_of[t] = -1;
    if (q0 < q1) {
      const int j0 = (int)(q0 / steps), j1 = (int)((q1 - 1) / steps);
      j0_of[t] = (signed char)j0;
      for (int j = j0; j <= j1; ++j) {   // the least and the greatest block: no order needed
        atomicMin(&first[j], t);
        atomicMax(&last[j], t);
      }
    }
  }
  __syncthreads();
  const int j = threadIdx.x / SUM_COLS, col = threadIdx.x % SUM_COLS;
  const int e = blockIdx.x * SUM_COLS + col;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (e < n4) {
    for (int b0 = first[j]; b0 <= last[j]; b0 += SUM_BATCH) {
      float4 v[SUM_BATCH];
#pragma unroll
      for (int u = 0; u < SUM_BATCH; ++u) {
        const int b = b0 + u;
        v[u] = b <= last[j] ? part[(size_t)(2 * b + (j0_of[b] == j ? 0 : 1)) * n4 + e]
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < SUM_BATCH; ++u)
        if (b0 + u <= last[j]) add4(acc, v[u]);
    }
  }
  sums[j][col] = acc;
  __syncthreads();
  if (j == 0 && e < n4) {
    float4 tot = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < NACC; ++k) add4(tot, sums[k][col]);
    out[e] = tot;
  }
}

// ---- host side ----------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = (EncodeTiled)p;
  }
  return fn;
}

// A 2-D map of a row-major (rows, cols) array with `elt`-byte elements, boxes of
// (box_rows, box_cols).
bool make_map(CUtensorMap* tm, const void* ptr, CUtensorMapDataType type, int elt, uint64_t rows,
              uint64_t cols, uint32_t box_rows, uint32_t box_cols, CUtensorMapSwizzle swz) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * (uint64_t)elt};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return enc(tm, type, 2, const_cast<void*>(ptr), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DT>
int launch(const void* a, const void* b, float* part, int S, int steps, int B, cudaStream_t st) {
  CUtensorMap ta{}, tb;
  bool ok;
  if constexpr (DT == DT_BF16)
    ok = make_map(&ta, a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, NACC * TILE, TILE, TILE, 64,
                  CU_TENSOR_MAP_SWIZZLE_128B) &&
         make_map(&tb, b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, NTILES * TILE, S, TILE, 64,
                  CU_TENSOR_MAP_SWIZZLE_128B);
  else if constexpr (DT == DT_INT8)   // b in its per-tile transposed layout: 64 S rows of 128 bytes
    ok = make_map(&ta, a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, NACC * TILE, TILE, TILE, TILE,
                  CU_TENSOR_MAP_SWIZZLE_128B) &&
         make_map(&tb, b, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, (uint64_t)NTILES * S, TILE, TILE,
                  TILE, CU_TENSOR_MAP_SWIZZLE_128B);
  else   // the consumers read a straight from device memory: no map of a
    ok = make_map(&tb, b, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, NTILES * TILE, S, TILE, TILE,
                  CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!ok) return (int)cudaErrorInvalidValue;
  // the shared-memory opt-in, once per device
  static bool attr_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(dot_chain_kernel<DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<DT>());
    if (err != cudaSuccess) return (int)err;
    attr_set[dev] = true;
  }
  dot_chain_kernel<DT><<<dim3(B, S / TILE), THREADS, smem_bytes<DT>(), st>>>(
      ta, tb, (const float*)a, part, S, steps, B);
  return (int)cudaGetLastError();
}

// The second grid: the fixed-order sum of `part` into `out`.
int sum_partials(const void* part, void* out, int S, int steps, int B, cudaStream_t st) {
  const int n4 = TILE * S / 4;
  dot_chain_sum_kernel<<<(n4 + SUM_COLS - 1) / SUM_COLS, SUM_THREADS, 0, st>>>(
      (const float4*)part, (float4*)out, n4, steps, B);
  return (int)cudaGetLastError();
}

}  // namespace

// One chain of `chain` dots on `stream`: a (1024, 128) and b (8192, S) of type
// dtype (0 bf16, 1 f32, 2 int8: b then in its per-tile transposed layout
// (64, S, 128)), part (2 * blocks, 128, S) f32 scratch, out (128, S) f32;
// `blocks` a column tile, at least 8 (each meets at most two accumulators)
// and at most 1,024.
// S is a positive multiple of 128; every pointer 16-byte aligned.
extern "C" int dot_chain_run(const void* a, const void* b, void* part, void* out, int S,
                             int chain, int blocks, int dtype, void* stream) {
  if (S < TILE || S % TILE || chain < 0 || blocks < 1 || dtype < DT_BF16 || dtype > DT_INT8 ||
      blocks > MAX_BLOCKS || (chain >= NACC && blocks < NACC))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int steps = chain / NACC;
  float* p = (float*)part;
  int rc;
  if (dtype == DT_F32)
    rc = launch<DT_F32>(a, b, p, S, steps, blocks, st);
  else if (dtype == DT_BF16)
    rc = launch<DT_BF16>(a, b, p, S, steps, blocks, st);
  else
    rc = launch<DT_INT8>(a, b, p, S, steps, blocks, st);
  if (rc != 0) return rc;
  return sum_partials(part, out, S, steps, blocks, st);
}
