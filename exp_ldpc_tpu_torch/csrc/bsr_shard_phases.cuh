// The two phases of one K4 iteration of one shard as device functions,
// shared by the kernels of bsr_shard.cu (one launch per phase) and the
// cooperative-launch variant timed by experiments/bench_grid_barrier.py
// (grid_barrier.cu).  Each walks its flat (row, shot vector) work list with
// the whole grid; the caller provides the barrier between the phases.  The
// message array is read with plain loads (never the read-only cache), so the
// functions are also correct around a grid-wide barrier inside one launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "spacetime_bp.cuh"
#include "vec_io.cuh"

struct ShardArgs {
  const int* chk_vars;           // (Dc*Cl,) slot-major, -1 = padded slot
  const int* nslot;              // (Cl,) slots scanned per check
  const int* lvar;               // (V_pad,) local variables first, then the rest
  const int* lvm;                // (n_loc*Dv,) local edge rows, -1 = pad
  const float* post;             // (V_pad, S)
  const __nv_bfloat16* msg_in;   // (Dc*Cl, S) c2v of the previous iteration
  const uint8_t* synd;           // (Cl, S)
  __nv_bfloat16* msg_out;        // (Dc*Cl, S) c2v out (may alias msg_in)
  float* part;                   // (V_pad, S) out, or in and out when accumulating
  int Cl, Dc, V_pad, n_loc, Dv, S;
};

// ---- phase A: broadcast and check update
template <int MAXP, int VEC, int METHOD>
__device__ __forceinline__ void bsr_shard_checks(const ShardArgs& a, float alpha) {
  const int Cl = a.Cl, Dc = a.Dc;
  const size_t SS = (size_t)a.S;
  RowItems items(Cl, a.S, VEC);
  int c, s0;
  while (items.next(c, s0, VEC)) {
    const int ns = __ldg(&a.nslot[c]);
    float x[VEC][MAXP];
    float t[VEC], m[VEC];
#pragma unroll
    for (int i = 0; i < MAXP; ++i) {
      if (i < ns) {
        const size_t row = (size_t)i * Cl + c;
        const int var = __ldg(&a.chk_vars[row]);
        ld_bf16<VEC>(a.msg_in + row * SS + s0, m);
        if (var >= 0) ld_f32<VEC>(a.post + (size_t)var * SS + s0, t);
#pragma unroll
        for (int v = 0; v < VEC; ++v) x[v][i] = bf(((var >= 0) ? bf(t[v]) : BIG) - m[v]);
      } else if (METHOD == 1) {  // min-sum scans all MAXP slots: +infinity is inert
#pragma unroll
        for (int v = 0; v < VEC; ++v) x[v][i] = INFINITY;
      }
    }
    if (ns > 0) {
      const Pack<VEC> sy = ld_raw_ro<VEC>(a.synd + (size_t)c * SS + s0);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        if (METHOD == 1)
          check_update_ms_all<MAXP>(x[v], sy.u8[v] ? -1.0f : 1.0f, alpha);
        else
          check_update<MAXP>(x[v], ns, sy.u8[v] ? -1.0f : 1.0f, METHOD, alpha);
      }
    }
#pragma unroll
    for (int i = 0; i < MAXP; ++i) {
      if (i < Dc) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) t[v] = (i < ns) ? x[v][i] : BIG;
        st_bf16<VEC>(a.msg_out + ((size_t)i * Cl + c) * SS + s0, t);
      }
    }
  }
}

// ---- phase A of route "wide": checks of more than MAX_SLOTS slots, in two
// passes over the scanned slots (WideCheck, spacetime_bp.cuh) after the
// broadcast.  Pass 2 broadcasts each slot again and stores its outgoing
// message (read before it is written: msg_out may alias msg_in); slots at
// or past nslot store +BIG, as in the register instances.
template <int VEC>
__device__ __forceinline__ void shard_v2c(const ShardArgs& a, int i, int c, int s0,
                                          float (&x)[VEC]) {
  const size_t row = (size_t)i * a.Cl + c;
  const int var = __ldg(&a.chk_vars[row]);
  float t[VEC], m[VEC];
  ld_bf16<VEC>(a.msg_in + row * a.S + s0, m);
  if (var >= 0) ld_f32<VEC>(a.post + (size_t)var * a.S + s0, t);
#pragma unroll
  for (int v = 0; v < VEC; ++v) x[v] = bf(((var >= 0) ? bf(t[v]) : BIG) - m[v]);
}

template <int VEC, int METHOD>
__device__ __forceinline__ void bsr_shard_checks_wide(const ShardArgs& a, float alpha) {
  const int Cl = a.Cl, Dc = a.Dc;
  const size_t SS = (size_t)a.S;
  RowItems items(Cl, a.S, VEC);
  int c, s0;
  while (items.next(c, s0, VEC)) {
    const int ns = __ldg(&a.nslot[c]);
    const Pack<VEC> sy = ld_raw_ro<VEC>(a.synd + (size_t)c * SS + s0);
    WideCheck w[VEC];
    float x[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) w[v].init(sy.u8[v] ? -1.0f : 1.0f);
    for (int i = 0; i < ns; ++i) {
      shard_v2c<VEC>(a, i, c, s0, x);
#pragma unroll
      for (int v = 0; v < VEC; ++v) w[v].fold(i, x[v], METHOD);
    }
    for (int i = 0; i < Dc; ++i) {
      if (i < ns) {
        shard_v2c<VEC>(a, i, c, s0, x);
#pragma unroll
        for (int v = 0; v < VEC; ++v) x[v] = w[v].out(i, x[v], METHOD, alpha);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) x[v] = BIG;
      }
      st_bf16<VEC>(a.msg_out + ((size_t)i * Cl + c) * SS + s0, x);
    }
  }
}

// ---- phase B: partial totals of the variables with a local edge
template <int VEC, bool ACCUMULATE>
__device__ __forceinline__ void bsr_shard_vars(const ShardArgs& a) {
  const int Dv = a.Dv, n_loc = a.n_loc;
  const size_t SS = (size_t)a.S;
  RowItems items(ACCUMULATE ? n_loc : a.V_pad, a.S, VEC);
  int i, s0;
  while (items.next(i, s0, VEC)) {
    float tot[VEC], tile[VEC], t[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) tot[v] = tile[v] = 0.0f;
    float* out = a.part + (size_t)__ldg(&a.lvar[i]) * SS + s0;
    if (i < n_loc) {
      int cur = -1;
      for (int j = 0; j < Dv; ++j) {
        const int k = __ldg(&a.lvm[(size_t)i * Dv + j]);
        if (k < 0) break;
        const int et = k >> 7;  // 128-row edge tile
        if (et != cur) {
          if (cur >= 0) {
#pragma unroll
            for (int v = 0; v < VEC; ++v) tot[v] = tot[v] + tile[v];
          }
#pragma unroll
          for (int v = 0; v < VEC; ++v) tile[v] = 0.0f;
          cur = et;
        }
        ld_bf16<VEC>(a.msg_out + (size_t)k * SS + s0, t);
#pragma unroll
        for (int v = 0; v < VEC; ++v) tile[v] = tile[v] + t[v];
      }
      if (cur >= 0) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) tot[v] = tot[v] + tile[v];
      }
    }
    if (ACCUMULATE) {
      ld_f32<VEC>(out, t);
#pragma unroll
      for (int v = 0; v < VEC; ++v) tot[v] = t[v] + tot[v];
    }
    st_f32<VEC>(out, tot);
  }
}
