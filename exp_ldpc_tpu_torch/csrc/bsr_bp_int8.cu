// K5: flat flooding min-sum BP in int8 fixed point, early exit per shot block.
//
// Replaces exp_ldpc_tpu/decoders/bp_bsr.py::_kernel_int8 (the int8 variant of
// the BSR-routed Pallas kernel, launched by bsr_bp_decode_int8).  Same
// contract, computed by bsr_bp_int8_plain in decoders/bp_bsr.py, which is this
// kernel's plain version, with the arithmetic of decoders/bp_int8.py:
//   * v2c messages are int8 in device memory, in the TannerELL check-major
//     layout (C*Dc rows); the initial message is clip(prior_q[var], +-127), a
//     padded slot holds +127 from the start to the end of the decode (nothing
//     rewrites it);
//   * check update in int32: sign = parity of the strictly negative messages
//     plus the syndrome bit; min1, min2 over the magnitudes of ALL Dc slots,
//     the padded ones counting as +127 (they are simply read), the first slot
//     that attains the minimum receives min2, and min2 starts at 128, which is
//     what a check of one slot sends; scaled = (ext * alpha_num) >> 8, negated
//     by the sign, stored as int8 (128 wraps to -128, as in the reference);
//   * posterior = int32 prior_q + the int8 c2v messages (unsaturated);
//     v2c = clip(clip(posterior, +-127) - c2v, +-127);
//   * parity of posterior <= 0 per shot, which sets conv; with early_stop it
//     is taken every iteration and a shot block whose live shots all pass
//     stops (the JAX kernel resets its done flag per grid step, so the exit
//     unit is its block of shot_block shots, as in K1).
// Integer sums do not depend on their order, so the results equal the plain
// version's, and the reference's in fixed-iteration mode, bit for bit.
//
// What bounds it on an H100: as K1, every iteration streams each message of
// each shot through device memory twice plus the int32 posterior, in short
// dependent chains of gathers; the messages are bytes.  The TPU kernel keeps
// a shot block's messages in VMEM and routes them with one-hot 128x128 int8
// tiles on the matrix unit; its dead-row value, live-slot plane skipping and
// one-hot scratch are devices of that layout and are not carried over.
//
// Design: K1's (bsr_bp.cu): three grids per iteration over (row, shot
// vector) items (A checks, B variables, C parity: bsr_phases.cuh), the loop
// in the C entry point, the early exit on the device (gbad per shot block,
// a `done` word closed by the last block of phase C).  A thread moves 16
// (checks of up to 8 slots, variables of up to 8 edges), 8 or 4 shots of a
// row with one access: a warp reads 256-512 consecutive bytes of a row.  The
// raw bytes of every slot stay packed in registers, and each shot's check
// and variable update runs on bytes extracted from them, in int32.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bsr_phases.cuh"

#define SAT 127

__device__ __forceinline__ int clip_sat(int x) { return min(max(x, -SAT), SAT); }
__device__ __forceinline__ int s8(uint8_t b) { return (int)(int8_t)b; }

// ---- phase A: min-sum check update of every check, in place on its live slots
template <int MAXP, bool EXACT, int VEC>
__device__ __forceinline__ void bsr8_checks(const BsrArgs& a, int it, int alpha_num) {
  const int Dc = EXACT ? MAXP : a.Dc;
  const size_t SS = (size_t)a.S;
  int8_t* msg = (int8_t*)a.msg;
  const int* prior_q = (const int*)a.prior;
  RowItems items(a.C, a.S, VEC);
  int c, s0;
  while (items.next(c, s0, VEC)) {
    if (bsr_stopped(a, it, s0 / a.sb)) continue;
    const size_t e0 = (size_t)c * Dc;
    Pack<VEC> m[MAXP];
    uint32_t live = 0;  // bit i: slot i holds an edge (one register, not MAXP predicates)
#pragma unroll
    for (int i = 0; i < MAXP; ++i) {
      if (i < Dc) {
        const int var = __ldg(&a.chk_vars[e0 + i]);
        live |= (uint32_t)(var >= 0) << i;
        if (it == 0) {  // the saturated prior of the slot's variable, +SAT on a padded slot
          const uint8_t b = (uint8_t)(int8_t)(var >= 0 ? clip_sat(__ldg(&prior_q[var])) : SAT);
#pragma unroll
          for (int v = 0; v < VEC; ++v) m[i].u8[v] = b;
        } else {
          m[i] = ld_raw<VEC>(msg + (e0 + i) * SS + s0);
        }
      }
    }
    const Pack<VEC> sy = ld_raw_ro<VEC>(a.synd + (size_t)c * SS + s0);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      int x0 = s8(m[0].u8[v]);
      int neg_tot = sy.u8[v] + (x0 < 0);
      int min1 = abs(x0), min2 = SAT + 1, arg = 0;
#pragma unroll
      for (int i = 1; i < MAXP; ++i) {
        if (i < Dc) {
          const int x = s8(m[i].u8[v]);
          neg_tot += x < 0;
          const int mg = abs(x);
          if (mg < min1) {
            min2 = min1;
            min1 = mg;
            arg = i;
          } else {
            min2 = min(min2, mg);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MAXP; ++i) {
        if (i < Dc && ((live >> i) & 1u)) {
          const int x = s8(m[i].u8[v]);
          const int scaled = (((i == arg) ? min2 : min1) * alpha_num) >> 8;
          const bool ext_neg = (neg_tot + (x < 0)) & 1;
          m[i].u8[v] = (uint8_t)(int8_t)(ext_neg ? -scaled : scaled);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MAXP; ++i)  // padded slots: +SAT, stored once in iteration 0
      if (i < Dc && (((live >> i) & 1u) || it == 0))
        st_raw<VEC>(msg + (e0 + i) * SS + s0, m[i]);
  }
}

// ---- phase A of route "wide": checks of more than MAX_SLOTS slots, in
// two passes over the slots (K1's bsr_checks_wide): pass 1 folds each slot's
// byte into the negative count, min1, min2 and argmin; pass 2 reads each
// live slot again and stores its outgoing message.  Integer arithmetic: the
// same values as phase A.
template <int VEC>
__device__ __forceinline__ Pack<VEC> bsr8_incoming(const BsrArgs& a, int it, size_t e, int var,
                                                   int s0) {
  Pack<VEC> m;
  if (it == 0) {  // the saturated prior of the slot's variable, +SAT on a padded slot
    const uint8_t b =
        (uint8_t)(int8_t)(var >= 0 ? clip_sat(__ldg(&((const int*)a.prior)[var])) : SAT);
#pragma unroll
    for (int v = 0; v < VEC; ++v) m.u8[v] = b;
  } else {
    m = ld_raw<VEC>((const int8_t*)a.msg + e * a.S + s0);
  }
  return m;
}

template <int VEC>
__device__ __forceinline__ void bsr8_checks_wide(const BsrArgs& a, int it, int alpha_num) {
  const int Dc = a.Dc;
  int8_t* msg = (int8_t*)a.msg;
  RowItems items(a.C, a.S, VEC);
  int c, s0;
  while (items.next(c, s0, VEC)) {
    if (bsr_stopped(a, it, s0 / a.sb)) continue;
    const size_t e0 = (size_t)c * Dc;
    const Pack<VEC> sy = ld_raw_ro<VEC>(a.synd + (size_t)c * a.S + s0);
    int neg_tot[VEC], min1[VEC], min2[VEC], arg[VEC];
    for (int i = 0; i < Dc; ++i) {
      const Pack<VEC> m = bsr8_incoming<VEC>(a, it, e0 + i, __ldg(&a.chk_vars[e0 + i]), s0);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const int x = s8(m.u8[v]);
        const int mg = abs(x);
        if (i == 0) {
          neg_tot[v] = sy.u8[v] + (x < 0);
          min1[v] = mg;
          min2[v] = SAT + 1;
          arg[v] = 0;
        } else {
          neg_tot[v] += x < 0;
          if (mg < min1[v]) {
            min2[v] = min1[v];
            min1[v] = mg;
            arg[v] = i;
          } else {
            min2[v] = min(min2[v], mg);
          }
        }
      }
    }
    for (int i = 0; i < Dc; ++i) {
      const int var = __ldg(&a.chk_vars[e0 + i]);
      if (var < 0 && it > 0) continue;  // padded slots: +SAT, stored once in iteration 0
      Pack<VEC> m = bsr8_incoming<VEC>(a, it, e0 + i, var, s0);
      if (var >= 0) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const int x = s8(m.u8[v]);
          const int scaled = ((i == arg[v] ? min2[v] : min1[v]) * alpha_num) >> 8;
          const bool ext_neg = (neg_tot[v] + (x < 0)) & 1;
          m.u8[v] = (uint8_t)(int8_t)(ext_neg ? -scaled : scaled);
        }
      }
      st_raw<VEC>(msg + (e0 + i) * a.S + s0, m);
    }
  }
}

// ---- phase B: posterior and the new v2c of every variable.  `out` and DVR
// as in K1's phase B.
template <int VEC, int DVR>
__device__ __forceinline__ void bsr8_vars(const BsrArgs& a, int it, bool out) {
  const int Dv = a.Dv;
  const size_t SS = (size_t)a.S;
  int8_t* msg = (int8_t*)a.msg;
  RowItems items(a.V, a.S, VEC);
  int u, s0;
  while (items.next(u, s0, VEC)) {
    if (bsr_stopped(a, it, s0 / a.sb)) continue;
    Pack<VEC> hd, t;
    if (out && u == 0) {  // conv starts at 1; phase C stores 0 on a violated check
#pragma unroll
      for (int v = 0; v < VEC; ++v) hd.u8[v] = 1;
      st_raw<VEC>(a.conv + s0, hd);
    }
    const int* edges = a.vm + (size_t)u * Dv;
    int total[VEC], p8[VEC];
    const int pr = __ldg(&((const int*)a.prior)[u]);
#pragma unroll
    for (int v = 0; v < VEC; ++v) total[v] = pr;
    if (DVR > 0) {
      Pack<VEC> m[DVR > 0 ? DVR : 1];
#pragma unroll
      for (int j = 0; j < DVR; ++j) {
        if (j < Dv) {
          const int k = __ldg(&edges[j]);
          if (k >= 0) {
            m[j] = ld_raw<VEC>(msg + (size_t)k * SS + s0);
#pragma unroll
            for (int v = 0; v < VEC; ++v) total[v] += s8(m[j].u8[v]);
          }
        }
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v) p8[v] = clip_sat(total[v]);
#pragma unroll
      for (int j = 0; j < DVR; ++j) {
        if (j < Dv) {
          const int k = __ldg(&edges[j]);
          if (k >= 0) {
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              t.u8[v] = (uint8_t)(int8_t)clip_sat(p8[v] - s8(m[j].u8[v]));
            st_raw<VEC>(msg + (size_t)k * SS + s0, t);
          }
        }
      }
    } else {
      for (int j = 0; j < Dv; ++j) {
        const int k = __ldg(&edges[j]);
        if (k >= 0) {
          t = ld_raw<VEC>(msg + (size_t)k * SS + s0);
#pragma unroll
          for (int v = 0; v < VEC; ++v) total[v] += s8(t.u8[v]);
        }
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v) p8[v] = clip_sat(total[v]);
      for (int j = 0; j < Dv; ++j) {
        const int k = __ldg(&edges[j]);
        if (k >= 0) {
          int8_t* p = msg + (size_t)k * SS + s0;
          t = ld_raw<VEC>(p);
#pragma unroll
          for (int v = 0; v < VEC; ++v) t.u8[v] = (uint8_t)(int8_t)clip_sat(p8[v] - s8(t.u8[v]));
          st_raw<VEC>(p, t);
        }
      }
    }
    if (out) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) hd.u8[v] = total[v] <= 0;
      st_raw<VEC>(a.hard + (size_t)u * SS + s0, hd);
      st_i32<VEC>((int*)a.post + (size_t)u * SS + s0, total);
    }
  }
}

// One grid per phase; each first reads `done` and returns at once when it is set.
template <int MAXP, bool EXACT, int VEC>
__global__ void __launch_bounds__(ROW_THREADS, 2) bsr_int8_check_kernel(const BsrArgs a, int it,
                                                                        int alpha_num) {
  if (a.flags && a.flags[BSR_DONE]) return;
  bsr8_checks<MAXP, EXACT, VEC>(a, it, alpha_num);
}

template <int VEC>
__global__ void __launch_bounds__(ROW_THREADS) bsr_int8_check_wide_kernel(const BsrArgs a, int it,
                                                                         int alpha_num) {
  if (a.flags && a.flags[BSR_DONE]) return;
  bsr8_checks_wide<VEC>(a, it, alpha_num);
}

template <int VEC, int DVR>
__global__ void __launch_bounds__(ROW_THREADS) bsr_int8_var_kernel(const BsrArgs a, int it,
                                                                   bool out) {
  if (a.flags && a.flags[BSR_DONE]) return;
  bsr8_vars<VEC, DVR>(a, it, out);
}

template <int VEC>
__global__ void __launch_bounds__(ROW_THREADS) bsr_int8_parity_kernel(const BsrArgs a, int it) {
  if (a.flags && a.flags[BSR_DONE]) return;
  bsr_parity<VEC>(a, it);
}

// Phase A by check width and lane width: the exact widths of the main
// path's codes (7, 8, 24) and the bounded scan up to 16 or 32 slots; 16
// shots a lane up to 8 slots, 8 up to 24, 4 above (the packed bytes of
// every slot in registers), 1 where the plan's width does not divide.
// Route "wide" (more than MAX_SLOTS slots): the two-pass scan, 16, 8, 4
// or 1 shots a lane.
static bool checks(const BsrArgs& a, int it, int vec, int alpha_num, int blocks, bool wide,
                   cudaStream_t st) {
#define WIDE(VEC)                                                                            \
  if (vec == VEC) {                                                                          \
    bsr_int8_check_wide_kernel<VEC><<<blocks, ROW_THREADS, 0, st>>>(a, it, alpha_num);       \
    return true;                                                                             \
  }
  if (wide) {
    WIDE(1) WIDE(4) WIDE(8) WIDE(16)
    return false;
  }
#undef WIDE
#define CASE(MAXP, EXACT, VEC)                                                           \
  if ((EXACT ? a.Dc == MAXP : a.Dc <= MAXP) && vec == VEC) {                             \
    bsr_int8_check_kernel<MAXP, EXACT, VEC><<<blocks, ROW_THREADS, 0, st>>>(a, it, alpha_num); \
    return true;                                                                         \
  }
  CASE(7, true, 1) CASE(7, true, 4) CASE(7, true, 8) CASE(7, true, 16)
  CASE(8, true, 1) CASE(8, true, 4) CASE(8, true, 8) CASE(8, true, 16)
  CASE(24, true, 1) CASE(24, true, 4) CASE(24, true, 8)
  CASE(16, false, 1) CASE(16, false, 4) CASE(16, false, 8) CASE(16, false, 16)
  CASE(32, false, 1) CASE(32, false, 4) CASE(32, false, 8)
#undef CASE
  return false;
}

// Phase B by variable degree (edges held in registers: up to 8, up to 24,
// or none) and lane width.
static bool vars(const BsrArgs& a, int it, bool out, int vec, int blocks, cudaStream_t st) {
#define CASE(DVR, VEC)                                                         \
  if (vec == VEC) {                                                            \
    bsr_int8_var_kernel<VEC, DVR><<<blocks, ROW_THREADS, 0, st>>>(a, it, out); \
    return true;                                                               \
  }
  if (a.Dv <= 8) {
    CASE(8, 1) CASE(8, 4) CASE(8, 8) CASE(8, 16)
  } else if (a.Dv <= 24) {
    CASE(24, 1) CASE(24, 4) CASE(24, 8)
  } else {
    CASE(0, 1) CASE(0, 4) CASE(0, 8) CASE(0, 16)
  }
#undef CASE
  return false;
}

static bool parity(const BsrArgs& a, int it, int vec, int blocks, cudaStream_t st) {
  switch (vec) {
    case 1: bsr_int8_parity_kernel<1><<<blocks, ROW_THREADS, 0, st>>>(a, it); return true;
    case 4: bsr_int8_parity_kernel<4><<<blocks, ROW_THREADS, 0, st>>>(a, it); return true;
    case 8: bsr_int8_parity_kernel<8><<<blocks, ROW_THREADS, 0, st>>>(a, it); return true;
    case 16: bsr_int8_parity_kernel<16><<<blocks, ROW_THREADS, 0, st>>>(a, it); return true;
    default: return false;
  }
}

// One whole decode, as K1's bsr_bp_run: n_iter iterations (at most 3 grids
// each), alpha = alpha_num / 256, gbad and flags both given for the early
// exit and both null for fixed iterations, lane widths, grids and route
// (BSR_GRIDS or BSR_WIDE) planned by the caller.
extern "C" int bsr_bp_int8_run(const void* chk_vars, const void* vm, const void* synd,
                               const void* prior_q, void* msg, void* post, void* conv, void* hard,
                               void* gbad, void* flags, int C, int V, int Dc, int Dv, int S,
                               int S_live, int sb, int G, int alpha_num, int n_iter, int vec_a,
                               int blocks_a, int vec_b, int blocks_b, int vec_c, int blocks_c,
                               int route, void* stream) {
  const BsrArgs a = {(const int*)chk_vars, (const int*)vm, nullptr, (const uint8_t*)synd,
                     prior_q, msg, post, (uint8_t*)conv, (uint8_t*)hard, (int*)gbad, (int*)flags,
                     C, V, Dc, Dv, S, S_live, sb, G, 0};
  if (!bsr_plan_ok(a, vec_a, vec_b, vec_c, route) || route == BSR_COOP ||
      (gbad == nullptr) != (flags == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool early = flags != nullptr;
  for (int it = 0; it < n_iter; ++it) {
    const bool out = early || it == n_iter - 1;
    if (!checks(a, it, vec_a, alpha_num, blocks_a, route == BSR_WIDE, st) ||
        !vars(a, it, out, vec_b, blocks_b, st) ||
        (out && !parity(a, it, vec_c, blocks_c, st)))
      return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
