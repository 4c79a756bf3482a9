// Shared device code of the row x shot kernels K1 (bsr_bp.cu), K3
// (stbsr.cu), K4 (bsr_shard.cu) and K5 (bsr_bp_int8.cu): a thread owns VEC
// consecutive shots of one row and moves them with one load or store of up
// to 16 bytes, and the flat (row, shot vector) work list that a launch
// spreads over the whole card.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define ROW_THREADS 256  // threads per block of every row x shot kernel

template <int N> struct RawT;
template <> struct RawT<1> { typedef uint8_t T; };
template <> struct RawT<2> { typedef uint16_t T; };
template <> struct RawT<4> { typedef uint32_t T; };
template <> struct RawT<8> { typedef uint2 T; };
template <> struct RawT<16> { typedef uint4 T; };

// N bytes moved as one word and read as bytes, halves or words.
template <int N> union Pack {
  typename RawT<N>::T raw;
  uint8_t u8[N];
  uint16_t u16[(N + 1) / 2];
  uint32_t u32[(N + 3) / 4];
};

template <int N> __device__ __forceinline__ Pack<N> ld_raw(const void* p) {
  Pack<N> k;
  k.raw = *reinterpret_cast<const typename RawT<N>::T*>(p);
  return k;
}

// Through the read-only cache: only for arrays no launch of the decode writes.
template <int N> __device__ __forceinline__ Pack<N> ld_raw_ro(const void* p) {
  Pack<N> k;
  k.raw = __ldg(reinterpret_cast<const typename RawT<N>::T*>(p));
  return k;
}

template <int N> __device__ __forceinline__ void st_raw(void* p, const Pack<N>& k) {
  *reinterpret_cast<typename RawT<N>::T*>(p) = k.raw;
}

template <int N> __device__ __forceinline__ void xor_into(Pack<N>& a, const Pack<N>& b) {
  if (N >= 4) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) a.u32[i] ^= b.u32[i];
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) a.u8[i] ^= b.u8[i];
  }
}

// bf16 <-> f32: widening is a 16-bit shift (exact), narrowing rounds to
// nearest even exactly as a tensor's .to(bfloat16) does.
template <int VEC>
__device__ __forceinline__ void ld_bf16(const __nv_bfloat16* p, float (&o)[VEC]) {
  const Pack<2 * VEC> k = ld_raw<2 * VEC>(p);
#pragma unroll
  for (int v = 0; v < VEC; ++v) o[v] = __uint_as_float((uint32_t)k.u16[v] << 16);
}

template <int VEC>
__device__ __forceinline__ void st_bf16(__nv_bfloat16* p, const float (&x)[VEC]) {
  Pack<2 * VEC> k;
#pragma unroll
  for (int v = 0; v < VEC; ++v) k.u16[v] = __bfloat16_as_ushort(__float2bfloat16_rn(x[v]));
  st_raw<2 * VEC>(p, k);
}

// f32: up to 4 values in one access, 8 in two of 16 bytes.
template <int VEC> __device__ __forceinline__ void ld_f32(const float* p, float (&o)[VEC]) {
  constexpr int W = VEC < 4 ? VEC : 4;
#pragma unroll
  for (int h = 0; h < VEC / W; ++h) {
    const Pack<4 * W> k = ld_raw<4 * W>(p + h * W);
#pragma unroll
    for (int v = 0; v < W; ++v) o[h * W + v] = __uint_as_float(k.u32[v]);
  }
}

template <int VEC> __device__ __forceinline__ void st_f32(float* p, const float (&x)[VEC]) {
  constexpr int W = VEC < 4 ? VEC : 4;
#pragma unroll
  for (int h = 0; h < VEC / W; ++h) {
    Pack<4 * W> k;
#pragma unroll
    for (int v = 0; v < W; ++v) k.u32[v] = __float_as_uint(x[h * W + v]);
    st_raw<4 * W>(p + h * W, k);
  }
}

// int32: as f32.
template <int VEC> __device__ __forceinline__ void st_i32(int* p, const int (&x)[VEC]) {
  constexpr int W = VEC < 4 ? VEC : 4;
#pragma unroll
  for (int h = 0; h < VEC / W; ++h) {
    Pack<4 * W> k;
#pragma unroll
    for (int v = 0; v < W; ++v) k.u32[v] = (uint32_t)x[h * W + v];
    st_raw<4 * W>(p + h * W, k);
  }
}

__device__ __forceinline__ float bf(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// The work list of one phase: `rows` rows of S shots, a thread per (row,
// VEC consecutive shots), rows outermost so that neighbouring threads touch
// neighbouring addresses.  S is a multiple of VEC (the caller's plan), so
// no item has a ragged tail.  Item `i` of the grid-stride loop:
//   row = i / (S / VEC), first shot = (i % (S / VEC)) * VEC.
struct RowItems {
  int sv, total, stride, item;
  __device__ __forceinline__ RowItems(int rows, int S, int vec)
      : sv(S / vec), total(rows * (S / vec)), stride(gridDim.x * ROW_THREADS),
        item(blockIdx.x * ROW_THREADS + threadIdx.x) {}
  __device__ __forceinline__ bool next(int& row, int& s0, int vec) {
    if (item >= total) return false;
    row = item / sv;
    s0 = (item - row * sv) * vec;
    item += stride;
    return true;
  }
};
