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
// 67 TFLOP/s on the CUDA cores (utils/bounds.py::dot_chain_bound).
//
// Design.  The TPU kernel holds a and b in VMEM and runs the whole chain on
// its one core.  Here the chain's steps are split over a grid of 8
// accumulators x P parts x S/128 column tiles (P from the SM count:
// experiments/bench_mxu_dtypes.py::dot_chain_parts), each part summing its
// steps from zero, and a second small kernel adds the (128, 128) partial sums
// in a fixed order: each accumulator's parts in order, then accumulators
// 0..7 in order (as the TPU kernel adds its accumulators), so the output is
// the same on every run.  A block keeps its a_j tile in shared memory and
// streams the b tiles of its steps through two shared-memory buffers with
// cp.async, the next tile loading while the current one is multiplied.  One
// block per SM, 8 warps (TMA and wgmma are for a later change).
//   bf16: mma.sync.aligned.m16n8k16 with f32 accumulation, a warp a 32 x 64
//     piece of the tile, A fragments by ldmatrix from a_j's rows, B fragments
//     by ldmatrix.trans from b's rows.  Every dot starts from zero and is
//     then added to the part's f32 sum, as the TPU kernel casts each dot and
//     adds it.
//   int8: mma.sync.aligned.m16n8k32 with s32 accumulation.  ldmatrix has no
//     b8 transpose on sm_90, so the kernel reads b with each tile transposed,
//     (64, S, 128) (experiments/bench_mxu_dtypes.py::b_tiles_nk, laid out once
//     per operand set).  A part sums its dots in int32 (exact: a dot is at
//     most 128 * 4 * 4 = 2,048 in magnitude for the probe's operands in
//     [-4, 4], so no overflow below 2^20 dots a part) and converts once to
//     f32.  That equals the TPU kernel's per-dot f32 sums wherever every
//     partial sum stays below 2^24 in magnitude, which holds for every chain
//     below 65,536 (chain/8 * 2,048 < 2^24) and in practice far beyond.
//   f32: FFMA on the CUDA cores (TF32 tensor cores would round the operands
//     to 10 bits: another function), a thread an 8 x 8 register tile, a_j
//     held transposed in shared memory; each dot starts from zero, one fused
//     multiply-add per product in k order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;     // operand tiles are 128 x 128; a block owns 128 output columns
constexpr int THREADS = 256;  // 8 warps
constexpr int NACC = 8;       // accumulators of the chain
constexpr int NTILES = 64;    // b tiles
enum { DT_BF16 = 0, DT_F32 = 1, DT_INT8 = 2 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 128 rows of RB bytes from global memory (row stride gstride bytes) to
// shared memory (row stride sstride bytes), 16 bytes a cp.async.
template <int RB>
__device__ __forceinline__ void load_tile(char* dst, int sstride, const char* src, size_t gstride) {
  constexpr int PIECES = RB / 16;
  for (int c = threadIdx.x; c < TILE * PIECES; c += THREADS) {
    const int r = c / PIECES, q = c - r * PIECES;
    cp_async16(dst + r * sstride + q * 16, src + r * gstride + q * 16);
  }
}

// The steps [lo, hi) of accumulator j's chain/8 that part p of P sums.
__device__ __forceinline__ void part_steps(int steps, int P, int p, int& lo, int& hi) {
  lo = (int)((long long)p * steps / P);
  hi = (int)((long long)(p + 1) * steps / P);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- bf16 and int8 on the tensor cores.  Shared memory rows are padded by 16
// bytes (272 or 144 bytes a row), so the 8 rows an ldmatrix reads fall in 8
// different 16-byte bank groups.
//   bf16: a_j [m][k] and the b tiles [k][n], 128 bf16 a row;
//   int8: a_j [m][k] and the b tiles transposed, [n][k], 128 bytes a row.
__host__ __device__ constexpr int mma_row(int dt) { return (dt == DT_INT8 ? 128 : 256) + 16; }

template <int DT>
__global__ void __launch_bounds__(THREADS, 1)
dot_chain_mma_kernel(const char* __restrict__ a, const char* __restrict__ b,
                     float* __restrict__ part, int S, int steps, int P) {
  constexpr int ROW = mma_row(DT);
  constexpr int ELT = DT == DT_INT8 ? 1 : 2;
  constexpr int RB = TILE * ELT;                       // bytes of one operand row
  extern __shared__ __align__(16) char smem[];
  char* As = smem;
  char* Bs = smem + TILE * ROW;                        // two buffers of TILE * ROW bytes
  const int j = blockIdx.x / P, p = blockIdx.x % P, n0 = blockIdx.y * TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 64;  // the warp's rows and columns
  int lo, hi;
  part_steps(steps, P, p, lo, hi);

  // where tile k of b starts, and its row stride (bytes)
  auto b_src = [&](int s) -> const char* {
    const int k = (s + NACC * j) % NTILES;
    return DT == DT_INT8 ? b + ((size_t)k * S + n0) * TILE
                         : b + ((size_t)k * TILE * S + n0) * ELT;
  };
  const size_t b_stride = DT == DT_INT8 ? (size_t)TILE : (size_t)S * ELT;

  load_tile<RB>(As, ROW, a + (size_t)j * TILE * RB, RB);
  cp_commit();
  if (lo < hi) {
    load_tile<RB>(Bs, ROW, b_src(lo), b_stride);
    cp_commit();
  }

  // the part's sum: f32 for bf16 (a dot at a time), int32 for int8 (exact)
  float accf[2][8][4];
  int acci[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        accf[mi][ni][e] = 0.0f;
        acci[mi][ni][e] = 0;
      }

  for (int s = lo; s < hi; ++s) {
    const char* Bcur = Bs + ((s - lo) & 1) * TILE * ROW;
    if (s + 1 < hi) {
      load_tile<RB>(Bs + ((s + 1 - lo) & 1) * TILE * ROW, ROW, b_src(s + 1), b_stride);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    float dot[2][8][4];
    if constexpr (DT == DT_BF16) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) dot[mi][ni][e] = 0.0f;
    }
    const int q = lane / 8, r8 = lane % 8;
#pragma unroll
    for (int kk = 0; kk < TILE * ELT / 32; ++kk) {     // 32 bytes of k an mma
      uint32_t af[2][4], bfr[4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)                   // rows +(q&1)*8, k bytes +(q>>1)*16
        ldsm_x4(af[mi], As + (wm + mi * 16 + r8 + (q & 1) * 8) * ROW + kk * 32 + (q >> 1) * 16);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int nb = wn + nj * 16;
        if constexpr (DT == DT_BF16)   // rows k: +(q&1)*8; columns n: +(q>>1)*8
          ldsm_x4_trans(bfr[nj], Bcur + (kk * 16 + r8 + (q & 1) * 8) * ROW +
                                     (nb + (q >> 1) * 8) * ELT);
        else                 // rows n: +(q>>1)*8; k bytes +(q&1)*16
          ldsm_x4(bfr[nj], Bcur + (nb + r8 + (q >> 1) * 8) * ROW + kk * 32 + (q & 1) * 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const uint32_t b0 = bfr[ni / 2][(ni % 2) * 2], b1 = bfr[ni / 2][(ni % 2) * 2 + 1];
          if constexpr (DT == DT_BF16)
            mma_bf16(dot[mi][ni], af[mi], b0, b1);
          else
            mma_s8(acci[mi][ni], af[mi], b0, b1);
        }
    }
    if constexpr (DT == DT_BF16) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) accf[mi][ni][e] += dot[mi][ni][e];
    }
    __syncthreads();   // the buffer just read is the next load's target
  }
  if (lo >= hi) cp_wait<0>();

  // the accumulator fragment: rows g and g + 8 of each m16 tile, columns 2 tig, 2 tig + 1
  const int g = lane / 4, tig = lane % 4;
  float* out = part + (size_t)(j * P + p) * TILE * S + n0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm + mi * 16 + g + h * 8, col = wn + ni * 8 + tig * 2;
        float2 v;
        if constexpr (DT == DT_BF16) {
          v.x = accf[mi][ni][2 * h];
          v.y = accf[mi][ni][2 * h + 1];
        } else {
          v.x = (float)acci[mi][ni][2 * h];
          v.y = (float)acci[mi][ni][2 * h + 1];
        }
        *reinterpret_cast<float2*>(out + (size_t)row * S + col) = v;
      }
}

// ---- f32 on the CUDA cores: a_j transposed in shared memory ([k][m], rows
// padded to 132 floats), the b tiles [k][n].  Thread (ty, tx) of 16 x 16 owns
// rows {4 ty .. 4 ty + 3, 64 + 4 ty ..} and columns {4 tx .., 64 + 4 tx ..}:
// its 16-byte reads of a b row are contiguous across a quarter warp.
constexpr int AT_ROW = TILE + 4;

__global__ void __launch_bounds__(THREADS, 1)
dot_chain_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ part, int S, int steps, int P) {
  extern __shared__ __align__(16) char smem[];
  float* At = reinterpret_cast<float*>(smem);           // [k][m]
  float* Bs = At + TILE * AT_ROW;                       // two buffers of [k][n]
  const int j = blockIdx.x / P, p = blockIdx.x % P, n0 = blockIdx.y * TILE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  int lo, hi;
  part_steps(steps, P, p, lo, hi);
  auto b_src = [&](int s) -> const char* {
    const int k = (s + NACC * j) % NTILES;
    return reinterpret_cast<const char*>(b + (size_t)k * TILE * S + n0);
  };
  if (lo < hi) {
    load_tile<TILE * 4>(reinterpret_cast<char*>(Bs), TILE * 4, b_src(lo), (size_t)S * 4);
    cp_commit();
  }
  const float* aj = a + (size_t)j * TILE * TILE;
  for (int c = threadIdx.x; c < TILE * TILE / 4; c += THREADS) {
    const int m = c / (TILE / 4), k4 = (c % (TILE / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>(aj + m * TILE + k4);
    At[(k4 + 0) * AT_ROW + m] = v.x;
    At[(k4 + 1) * AT_ROW + m] = v.y;
    At[(k4 + 2) * AT_ROW + m] = v.z;
    At[(k4 + 3) * AT_ROW + m] = v.w;
  }
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;

  for (int s = lo; s < hi; ++s) {
    const float* Bcur = Bs + ((s - lo) & 1) * TILE * TILE;
    if (s + 1 < hi) {
      load_tile<TILE * 4>(reinterpret_cast<char*>(Bs + ((s + 1 - lo) & 1) * TILE * TILE), TILE * 4,
                          b_src(s + 1), (size_t)S * 4);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    float dot[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) dot[r][c] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < TILE; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(At + k * AT_ROW + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(At + k * AT_ROW + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(Bcur + k * TILE + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(Bcur + k * TILE + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) dot[r][c] = __fmaf_rn(av[r], bv[c], dot[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] += dot[r][c];
    __syncthreads();
  }
  if (lo >= hi) {
    cp_wait<0>();
  }
  float* out = part + (size_t)(j * P + p) * TILE * S + n0;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = (r < 4 ? 0 : 64) + ty * 4 + (r & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 v = make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2],
                                   acc[r][4 * h + 3]);
      *reinterpret_cast<float4*>(out + (size_t)row * S + h * 64 + tx * 4) = v;
    }
  }
}

// ---- the fixed-order sum of the partial sums: out = ((acc_0 + acc_1) + ...) + acc_7,
// acc_j = ((part_j0 + part_j1) + ...) + part_j(P-1).
__global__ void dot_chain_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                                     int n, int P) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float tot = 0.0f;
  for (int j = 0; j < NACC; ++j) {
    float acc = part[(size_t)j * P * n + e];
    for (int p = 1; p < P; ++p) acc += part[((size_t)j * P + p) * n + e];
    tot = j == 0 ? acc : tot + acc;
  }
  out[e] = tot;
}

template <typename T>
int launch_chain(void (*kernel)(const T*, const T*, float*, int, int, int), int smem, dim3 grid,
                 cudaStream_t st, const T* a, const T* b, float* part, int S, int steps, int P) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, st>>>(a, b, part, S, steps, P);
  return (int)cudaGetLastError();
}

}  // namespace

// One chain of `chain` dots on `stream`: a (1024, 128) and b (8192, S) of type
// dtype (0 bf16, 1 f32, 2 int8: b then in its per-tile transposed layout
// (64, S, 128)), part (8 * parts, 128, S) f32 scratch, out (128, S) f32.  S is a
// positive multiple of 128; every pointer 16-byte aligned.
extern "C" int dot_chain_run(const void* a, const void* b, void* part, void* out, int S,
                             int chain, int parts, int dtype, void* stream) {
  if (S < TILE || S % TILE || chain < 0 || parts < 1 || dtype < DT_BF16 || dtype > DT_INT8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int steps = chain / NACC;
  const dim3 grid(NACC * parts, S / TILE);
  float* p = (float*)part;
  int rc;
  if (dtype == DT_F32)
    rc = launch_chain(dot_chain_f32_kernel, (TILE * AT_ROW + 2 * TILE * TILE) * 4, grid, st,
                      (const float*)a, (const float*)b, p, S, steps, parts);
  else if (dtype == DT_BF16)
    rc = launch_chain(dot_chain_mma_kernel<DT_BF16>, 3 * TILE * mma_row(DT_BF16), grid, st,
                      (const char*)a, (const char*)b, p, S, steps, parts);
  else
    rc = launch_chain(dot_chain_mma_kernel<DT_INT8>, 3 * TILE * mma_row(DT_INT8), grid, st,
                      (const char*)a, (const char*)b, p, S, steps, parts);
  if (rc != 0) return rc;
  const int n = TILE * S;
  dot_chain_sum_kernel<<<(n + 255) / 256, 256, 0, st>>>(p, (float*)out, n, parts);
  return (int)cudaGetLastError();
}
