// Shared device code of the streamed routes of K2 (stbp.cu) and K6
// (bpflat.cu): the f32 message state of every shot lives in device memory,
// (row, S) shot-minor, and each phase of an iteration is one grid over a
// flat list of (row, shot vector) items (csrc/vec_io.cuh::RowItems), planned
// in Python (utils/cuda_build.py::streamed_plan), as in K1 and K3.  A thread
// owns VEC consecutive shots of one row and moves them with 16-byte (VEC 4)
// or 4-byte (VEC 1) accesses; its neighbours own the next shots of the same
// row, so warp accesses coalesce.  The shot axis is padded to a multiple of
// STREAM_SHOT_ALIGN (all-zero syndromes; the wrappers drop the padded
// columns), so no item has a ragged tail.
//
// No pass initialises the messages: in the first iteration the check phase
// reads each slot's v2c message as its variable's prior (through the
// tables), and it never reads or writes a padded slot (it enters the check
// update as +BIG, as the plain version holds it).  Every array the decode
// writes is read with plain loads; the tables and priors, which no launch
// writes, through the read-only cache.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "spacetime_bp.cuh"
#include "vec_io.cuh"

#define STREAM_SHOT_ALIGN 4  // utils/cuda_build.py::STREAMED_SHOT_ALIGN
#define STREAM_DV_REG 8      // a variable of at most this degree keeps its messages in registers

// The min-sum scaling of iteration `it`: alpha0, or 1 - 2^-(it+1) when
// alpha0 == 0 (as the plain versions' alpha_at), in float.
static inline float stream_alpha(float alpha0, int it) {
  return (alpha0 == 0.0f) ? 1.0f - ldexpf(1.0f, -(it + 1)) : alpha0;
}

// VEC shots of one check slot: +BIG for a padded slot (v < 0), the prior of
// variable `v` in the first iteration, else the v2c message at `p`.
template <int VEC>
__device__ __forceinline__ void stream_slot(int v, bool first, const float* prior,
                                            const float* p, float (&t)[VEC]) {
  if (v < 0 || first) {
    const float x = (v < 0) ? BIG : __ldg(&prior[v]);
#pragma unroll
    for (int k = 0; k < VEC; ++k) t[k] = x;
  } else {
    ld_f32<VEC>(p, t);
  }
}

// The variable update of one variable row for VEC shots: its messages at
// rows base + vm_row[j] (j < Dv, -1 = pad) summed in edge order from 0,
// then the prior added; the last iteration stores the posterior at `post`
// and leaves the messages, the others store each outgoing v2c message
// (posterior minus incoming) in place.
template <int VEC>
__device__ __forceinline__ void stream_var(float* msg, size_t base, const int* vm_row, int Dv,
                                           float prior, size_t SS, int s0, bool last,
                                           float* post) {
  float total[VEC], pv[VEC], t[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) total[k] = 0.0f;
  if (Dv <= STREAM_DV_REG) {
    float m[STREAM_DV_REG][VEC];
    int kk[STREAM_DV_REG];
#pragma unroll
    for (int j = 0; j < STREAM_DV_REG; ++j) {
      kk[j] = (j < Dv) ? __ldg(&vm_row[j]) : -1;
      if (kk[j] >= 0) {
        ld_f32<VEC>(msg + (base + kk[j]) * SS + s0, m[j]);
#pragma unroll
        for (int k = 0; k < VEC; ++k) total[k] += m[j][k];
      }
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) pv[k] = prior + total[k];
    if (last) {
      st_f32<VEC>(post, pv);
      return;
    }
#pragma unroll
    for (int j = 0; j < STREAM_DV_REG; ++j) {
      if (kk[j] >= 0) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) t[k] = pv[k] - m[j][k];
        st_f32<VEC>(msg + (base + kk[j]) * SS + s0, t);
      }
    }
    return;
  }
  for (int j = 0; j < Dv; ++j) {
    const int e = __ldg(&vm_row[j]);
    if (e >= 0) {
      ld_f32<VEC>(msg + (base + e) * SS + s0, t);
#pragma unroll
      for (int k = 0; k < VEC; ++k) total[k] += t[k];
    }
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) pv[k] = prior + total[k];
  if (last) {
    st_f32<VEC>(post, pv);
    return;
  }
  for (int j = 0; j < Dv; ++j) {
    const int e = __ldg(&vm_row[j]);
    if (e >= 0) {
      float* p = msg + (base + e) * SS + s0;
      ld_f32<VEC>(p, t);
#pragma unroll
      for (int k = 0; k < VEC; ++k) t[k] = pv[k] - t[k];
      st_f32<VEC>(p, t);
    }
  }
}

// conv of VEC shots starts at 1 (the variable grid's row-0 items store it);
// the parity grid stores 0 where a check is violated.
template <int VEC>
__device__ __forceinline__ void stream_conv_one(uint8_t* conv) {
  Pack<VEC> one;
#pragma unroll
  for (int k = 0; k < VEC; ++k) one.u8[k] = 1;
  st_raw<VEC>(conv, one);
}

// The hard decisions (posterior <= 0) of VEC shots of one posterior row,
// xored into `par`.
template <int VEC>
__device__ __forceinline__ void stream_parity_xor(Pack<VEC>& par, const float* post) {
  float t[VEC];
  ld_f32<VEC>(post, t);
#pragma unroll
  for (int k = 0; k < VEC; ++k) par.u8[k] ^= (t[k] <= 0.0f);
}

template <int VEC>
__device__ __forceinline__ void stream_parity_store(const Pack<VEC>& par, uint8_t* conv) {
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    if (par.u8[k]) conv[k] = 0;
}
