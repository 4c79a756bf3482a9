// The three phases of one K3 iteration as device functions, shared by the
// kernels of stbsr.cu (one launch per phase) and the cooperative-launch
// variant timed by experiments/bench_grid_barrier.py (grid_barrier.cu).
// Each walks its flat (row, shot vector) work list with the whole grid; the
// caller provides the barrier between phases.  Arrays that a decode writes
// are read with plain loads (never the read-only cache), so the functions
// are also correct between grid-wide barriers inside one launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "spacetime_bp.cuh"
#include "vec_io.cuh"

#define DV_REG 8  // a data variable of at most this degree keeps its messages in registers

enum { F_DONE = 0, F_ITERS = 1, F_BAD = 2, F_TICKET = 3 };

struct StArgs {
  const int* chk_vars;    // (r*Dc,), -1 = padded slot
  const int* vm;          // (n*Dv,), flat check-major slot, -1 = pad
  __nv_bfloat16* msg;     // (B*r*Dc, S) v2c in, v2c out
  __nv_bfloat16* mlo;     // (R*r, S) m_b <-> check block b
  __nv_bfloat16* mhi;     // (R*r, S) m_b <-> check block b+1
  const uint8_t* synd;    // (B*r, S)
  const float* prior_d;   // (B*n,)
  const float* mprior;    // (R*r,)
  float* post_d;          // (B*n, S) out
  float* post_m;          // (R*r, S) out
  uint8_t* conv;          // (S,) out
  float* c2m;             // (2*R*r, S) scratch: c2m_lo then c2m_hi
  uint8_t* hard;          // (B*n + R*r, S) scratch: hard decisions, data then measurement
  int* flags;             // (4,) done, iters, bad, ticket; null = fixed iterations
  int r, n, Dc, Dv, R, S, S_live;
};

// ---- phase A: check update of every check of every round block
template <int MAXP, int VEC, int METHOD>
__device__ __forceinline__ void stbsr_checks(const StArgs& a, float alpha) {
  const int B = a.R + 1, P = a.Dc + 2, Dc = a.Dc, R = a.R, r = a.r;
  const size_t SS = (size_t)a.S;
  float* c2m_lo = a.c2m;                        // check block b -> m_b
  float* c2m_hi = a.c2m + (size_t)R * r * SS;   // check block b+1 -> m_b
  RowItems items(B * r, a.S, VEC);
  int q, s0;
  while (items.next(q, s0, VEC)) {
    const int b = q / r, c = q - b * r;
    const size_t e0 = (size_t)q * Dc;
    const size_t m_prev = (size_t)(q - r) * SS + s0;  // m_{b-1}
    const size_t m_next = (size_t)q * SS + s0;        // m_b
    float vhi[VEC], vlo[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) vhi[v] = vlo[v] = BIG;
    if (b > 0) ld_bf16<VEC>(a.mhi + m_prev, vhi);
    if (b < R) ld_bf16<VEC>(a.mlo + m_next, vlo);
    const Pack<VEC> sy = ld_raw_ro<VEC>(a.synd + (size_t)q * SS + s0);
    float x[VEC][MAXP];
    float t[VEC];
    if (METHOD == 1 && MAXP <= 16) {
      // Min-sum: the data messages in slots 0..Dc-1, +infinity (inert) up to
      // MAXP-3, then the upper and the lower measurement message in the last
      // two slots: the plain version's order, every index a constant, no
      // bound on any loop.  Measured 4% faster per decode than the bounded
      // scan below at MAXP = 10 and 18% slower at MAXP = 28 (H100), so wide
      // checks take the bounded scan.
#pragma unroll
      for (int i = 0; i < MAXP - 2; ++i) {
        if (i < Dc) ld_bf16<VEC>(a.msg + (e0 + i) * SS + s0, t);
#pragma unroll
        for (int v = 0; v < VEC; ++v) x[v][i] = (i < Dc) ? t[v] : INFINITY;
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        x[v][MAXP - 2] = vhi[v];
        x[v][MAXP - 1] = vlo[v];
        check_update_ms_all<MAXP>(x[v], sy.u8[v] ? -1.0f : 1.0f, alpha);
        vhi[v] = x[v][MAXP - 2];
        vlo[v] = x[v][MAXP - 1];
      }
    } else {
      // The bounded scan of exactly Dc + 2 slots (sum-product sums every
      // scanned slot, so it cannot pad): the data messages, then the two
      // measurement messages at Dc and Dc + 1.
      // Every slot is written and read back by selects on the unrolled
      // index, never under a branch on it: a chain of `if (i == Dc)` stores
      // is merged by the compiler into one store at a run-time index, which
      // moves the whole array to local memory.
#pragma unroll
      for (int i = 0; i < MAXP; ++i) {
        if (i < Dc) ld_bf16<VEC>(a.msg + (e0 + i) * SS + s0, t);
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          x[v][i] = (i < Dc) ? t[v] : ((i == Dc) ? vhi[v] : vlo[v]);
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        check_update<MAXP>(x[v], P, sy.u8[v] ? -1.0f : 1.0f, METHOD, alpha);
#pragma unroll
      for (int i = 0; i < MAXP; ++i) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          vhi[v] = (i == Dc) ? x[v][i] : vhi[v];
          vlo[v] = (i == Dc + 1) ? x[v][i] : vlo[v];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MAXP - 2; ++i) {
      if (i < Dc && __ldg(&a.chk_vars[c * Dc + i]) >= 0) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) t[v] = x[v][i];
        st_bf16<VEC>(a.msg + (e0 + i) * SS + s0, t);
      }
    }
    if (b > 0) st_f32<VEC>(c2m_hi + m_prev, vhi);
    if (b < R) st_f32<VEC>(c2m_lo + m_next, vlo);
  }
}

// ---- phase A of route "wide": checks of more than MAX_SLOTS slots (Dc + 2
// > 32), in two passes over the slots (WideCheck, spacetime_bp.cuh): the Dc
// data messages, then the upper (slot Dc) and the lower (slot Dc + 1)
// measurement message, the order of the register instances.  Pass 2 reads
// each data slot again and stores its outgoing message in place.
template <int VEC, int METHOD>
__device__ __forceinline__ void stbsr_checks_wide(const StArgs& a, float alpha) {
  const int B = a.R + 1, Dc = a.Dc, R = a.R, r = a.r;
  const size_t SS = (size_t)a.S;
  float* c2m_lo = a.c2m;
  float* c2m_hi = a.c2m + (size_t)R * r * SS;
  RowItems items(B * r, a.S, VEC);
  int q, s0;
  while (items.next(q, s0, VEC)) {
    const int b = q / r, c = q - b * r;
    const size_t e0 = (size_t)q * Dc;
    const size_t m_prev = (size_t)(q - r) * SS + s0;  // m_{b-1}
    const size_t m_next = (size_t)q * SS + s0;        // m_b
    float vhi[VEC], vlo[VEC], t[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) vhi[v] = vlo[v] = BIG;
    if (b > 0) ld_bf16<VEC>(a.mhi + m_prev, vhi);
    if (b < R) ld_bf16<VEC>(a.mlo + m_next, vlo);
    const Pack<VEC> sy = ld_raw_ro<VEC>(a.synd + (size_t)q * SS + s0);
    WideCheck w[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) w[v].init(sy.u8[v] ? -1.0f : 1.0f);
    for (int i = 0; i < Dc; ++i) {
      ld_bf16<VEC>(a.msg + (e0 + i) * SS + s0, t);
#pragma unroll
      for (int v = 0; v < VEC; ++v) w[v].fold(i, t[v], METHOD);
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      w[v].fold(Dc, vhi[v], METHOD);
      w[v].fold(Dc + 1, vlo[v], METHOD);
    }
    for (int i = 0; i < Dc; ++i) {
      if (__ldg(&a.chk_vars[c * Dc + i]) < 0) continue;
      ld_bf16<VEC>(a.msg + (e0 + i) * SS + s0, t);
#pragma unroll
      for (int v = 0; v < VEC; ++v) t[v] = w[v].out(i, t[v], METHOD, alpha);
      st_bf16<VEC>(a.msg + (e0 + i) * SS + s0, t);
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      vhi[v] = w[v].out(Dc, vhi[v], METHOD, alpha);
      vlo[v] = w[v].out(Dc + 1, vlo[v], METHOD, alpha);
    }
    if (b > 0) st_f32<VEC>(c2m_hi + m_prev, vhi);
    if (b < R) st_f32<VEC>(c2m_lo + m_next, vlo);
  }
}

// ---- phase B: measurement variables (closed form), then data variables
template <int VEC>
__device__ __forceinline__ void stbsr_vars(const StArgs& a, bool write_post) {
  const int B = a.R + 1, Dc = a.Dc, Dv = a.Dv, r = a.r, n = a.n;
  const int nm = a.R * r;
  const size_t SS = (size_t)a.S;
  const float* c2m_lo = a.c2m;
  const float* c2m_hi = a.c2m + (size_t)nm * SS;
  uint8_t* hard_m = a.hard + (size_t)B * n * SS;
  RowItems items(nm + B * n, a.S, VEC);
  int u, s0;
  while (items.next(u, s0, VEC)) {
    Pack<VEC> hd;
    if (u == 0) {  // conv starts every iteration at 1; phase C stores 0 on a violated check
#pragma unroll
      for (int v = 0; v < VEC; ++v) hd.u8[v] = 1;
      st_raw<VEC>(a.conv + s0, hd);
    }
    if (u < nm) {
      const size_t idx = (size_t)u * SS + s0;
      float lo[VEC], hi[VEC], pm[VEC];
      ld_f32<VEC>(c2m_lo + idx, lo);
      ld_f32<VEC>(c2m_hi + idx, hi);
      const float mp = __ldg(&a.mprior[u]);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        pm[v] = (mp + lo[v]) + hi[v];
        lo[v] = pm[v] - lo[v];
        hi[v] = pm[v] - hi[v];
        hd.u8[v] = pm[v] <= 0.0f;
      }
      st_bf16<VEC>(a.mlo + idx, lo);
      st_bf16<VEC>(a.mhi + idx, hi);
      if (write_post) st_f32<VEC>(a.post_m + idx, pm);
      st_raw<VEC>(hard_m + idx, hd);
      continue;
    }
    const int bv = u - nm, b = bv / n, var = bv - b * n;
    const size_t eb = (size_t)b * r * Dc;
    const size_t out = (size_t)bv * SS + s0;
    float total[VEC], pb[VEC], t[VEC];
    const float pr = __ldg(&a.prior_d[bv]);
#pragma unroll
    for (int v = 0; v < VEC; ++v) total[v] = pr;
    if (Dv <= DV_REG) {
      float m[DV_REG][VEC];
#pragma unroll
      for (int j = 0; j < DV_REG; ++j) {
        if (j < Dv) {
          const int k = __ldg(&a.vm[var * Dv + j]);
          if (k >= 0) {
            ld_bf16<VEC>(a.msg + (eb + k) * SS + s0, m[j]);
#pragma unroll
            for (int v = 0; v < VEC; ++v) total[v] += m[j][v];
          }
        }
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        pb[v] = bf(total[v]);
        hd.u8[v] = pb[v] <= 0.0f;
      }
#pragma unroll
      for (int j = 0; j < DV_REG; ++j) {
        if (j < Dv) {
          const int k = __ldg(&a.vm[var * Dv + j]);
          if (k >= 0) {
#pragma unroll
            for (int v = 0; v < VEC; ++v) t[v] = pb[v] - m[j][v];
            st_bf16<VEC>(a.msg + (eb + k) * SS + s0, t);
          }
        }
      }
    } else {
      for (int j = 0; j < Dv; ++j) {
        const int k = __ldg(&a.vm[var * Dv + j]);
        if (k >= 0) {
          ld_bf16<VEC>(a.msg + (eb + k) * SS + s0, t);
#pragma unroll
          for (int v = 0; v < VEC; ++v) total[v] += t[v];
        }
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        pb[v] = bf(total[v]);
        hd.u8[v] = pb[v] <= 0.0f;
      }
      for (int j = 0; j < Dv; ++j) {
        const int k = __ldg(&a.vm[var * Dv + j]);
        if (k >= 0) {
          __nv_bfloat16* p = a.msg + (eb + k) * SS + s0;
          ld_bf16<VEC>(p, t);
#pragma unroll
          for (int v = 0; v < VEC; ++v) t[v] = pb[v] - t[v];
          st_bf16<VEC>(p, t);
        }
      }
    }
    if (write_post) st_f32<VEC>(a.post_d + out, total);
    st_raw<VEC>(a.hard + out, hd);
  }
}

// ---- phase C: exact spacetime syndrome check of this iteration's estimate
template <int VEC>
__device__ __forceinline__ void stbsr_parity(const StArgs& a) {
  const int B = a.R + 1, Dc = a.Dc, R = a.R, r = a.r, n = a.n;
  const size_t SS = (size_t)a.S;
  const uint8_t* hard_m = a.hard + (size_t)B * n * SS;
  int any = 0;
  RowItems items(B * r, a.S, VEC);
  int q, s0;
  while (items.next(q, s0, VEC)) {
    const int b = q / r, c = q - b * r;
    Pack<VEC> par = ld_raw_ro<VEC>(a.synd + (size_t)q * SS + s0);
    for (int i = 0; i < Dc; ++i) {
      const int v = __ldg(&a.chk_vars[c * Dc + i]);
      if (v >= 0) xor_into<VEC>(par, ld_raw<VEC>(a.hard + (size_t)(b * n + v) * SS + s0));
    }
    if (b > 0) xor_into<VEC>(par, ld_raw<VEC>(hard_m + (size_t)(q - r) * SS + s0));
    if (b < R) xor_into<VEC>(par, ld_raw<VEC>(hard_m + (size_t)q * SS + s0));
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      if (par.u8[v]) {
        a.conv[s0 + v] = 0;
        if (s0 + v < a.S_live) any = 1;
      }
    }
  }
  if (a.flags == nullptr) return;  // uniform: every thread of the grid sees the same pointer
  // Early exit: the last block to finish closes the iteration.  Every block
  // publishes its "a live shot is unconverged" bit before it takes a ticket,
  // so the holder of the last ticket sees them all.
  const int blk_bad = __syncthreads_or(any);
  if (threadIdx.x == 0) {
    if (blk_bad) atomicOr(&a.flags[F_BAD], 1);
    __threadfence();
    if (atomicAdd(&a.flags[F_TICKET], 1) == (int)gridDim.x - 1) {
      const int bad = atomicExch(&a.flags[F_BAD], 0);
      a.flags[F_TICKET] = 0;
      a.flags[F_ITERS] += 1;
      if (!bad) a.flags[F_DONE] = 1;
    }
  }
}
