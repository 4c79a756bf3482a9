// K1: flat flooding BP with bf16 messages and an early exit per shot block.
//
// Replaces exp_ldpc_tpu/decoders/bp_bsr.py::_kernel (the BSR-routed Pallas
// kernel launched by bsr_bp_decode) and its rolled twin _kernel_dyn (K1b).
// Same contract, computed by bsr_bp_plain in decoders/bp_bsr.py, which is
// this kernel's plain version:
//   * v2c messages are bf16 in device memory, in the TannerELL check-major
//     layout (C*Dc rows); the initial message is bf16(prior[var]), a padded
//     slot bf16(+1e30);
//   * check update in f32 on the bf16 messages ("ps" sign/phi over all Dc
//     slots, or "ms" min-sum with fixed or adaptive alpha), c2v stored bf16;
//     a padded slot below nslot[c] is rewritten to bf16(1e30 - c2v), as the
//     TPU kernel's broadcast rewrites it;
//   * posterior = f32 prior + the bf16 c2v messages, in the variable's edge
//     order; v2c = bf16(bf16(posterior) - c2v);
//   * parity of bf16(posterior) per shot, which sets conv; with early_stop
//     it is taken every iteration and a shot block whose live shots all pass
//     stops: the JAX kernel resets its done flag per grid step, so the exit
//     unit is its block of shot_block shots (128 or 256), not the batch.
//
// What bounds it on an H100: every iteration streams each bf16 message of
// each shot through device memory twice (checks, then variables), plus the
// posterior, in short dependent chains of gathers through the Tanner
// tables: memory latency and bandwidth, not arithmetic.  The TPU kernel
// keeps a shot block's state in VMEM and routes it with one-hot 128x128
// tiles on the matrix unit; neither carries over.
//
// Design (K3's, csrc/stbsr.cu).  Each phase of an iteration is a flat list
// of (row, shot vector) items spread over a grid sized from the item count
// and the SM count (utils/cuda_build.py::bsr_plan), so 1,024 shots of a
// 1,540-check code fill the card as 16,384 shots of a 108-check code do.  A
// thread owns VEC consecutive shots of one row (one 8- or 16-byte access);
// its neighbours own the next shots of the same row, so warp accesses
// coalesce.  Three grids per iteration, the kernel boundary being the
// barrier between rows that share shots:
//   A  every check: check update, messages stored in place (in iteration 0
//      the incoming messages are the priors, read from the prior vector);
//   B  every variable: posterior (f32, written where it is an output), one
//      byte of bf16(posterior) <= 0 for phase C, v2c in place; up to 8 or
//      24 edges are held in registers between the sum and the broadcast;
//   C  every check's parity from those bytes (bsr_phases.cuh): conv set in
//      B and cleared in C; a violated live shot marks its shot block in
//      gbad[it], and the last block to finish sets `done` once no shot block
//      is marked.
// The iteration loop runs in the C entry point: one call enqueues a whole
// decode and the host reads nothing back.  An item whose shot block stopped
// (gbad[it-1][g] == 0) does nothing, and once `done` is set every later grid
// returns at once.  In fixed-iteration mode there is no flag traffic, and B
// writes the posterior and C runs in the last iteration only.  VEC divides
// the shot count and the shot block (the plan), so no item straddles two
// blocks.  Where every phase's grid fits the card at once (a few hundred
// shots: the host redecode), min-sum runs the same phases in one
// cooperative launch with grid-wide barriers between them (route "coop",
// below), where launches would bound the time.  Checks of more than
// MAX_SLOTS (32) slots, as in the fault matrices of detector error
// models, take route "wide": phase A in two passes over the slots, whose
// registers do not grow with Dc (bsr_checks_wide).  Each check, variable and
// parity is computed by one thread in the plain version's order, so results
// are bit-identical to it.
//
// The profiling hook `ablate` of the TPU kernel (bp_bsr.py:231-236, driven by
// experiments/bench_bsr_ablation.py) takes one cost centre out to split the
// kernel's time: BSR_NO_CHECK skips grid A (grid B then reads the v2c
// messages as c2v; in iteration 0 they are the priors, which grid A would
// have read); BSR_NO_ROUTE replaces grid B by a copy grid (bsr_copy: the
// posterior is the prior, every message, padded slots included, negated),
// after which phase C finds parity 0.  As the TPU kernel turns its dead-plane
// skipping off under an ablation (bp_bsr.py:263), grid A then stores c2v in
// every slot.  Production callers pass BSR_FULL.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bsr_phases.cuh"

namespace cg = cooperative_groups;

enum { BSR_FULL = 0, BSR_NO_CHECK = 1, BSR_NO_ROUTE = 2 };  // BsrArgs::ablate

__device__ __forceinline__ float bf16_bits(uint16_t u) { return __uint_as_float((uint32_t)u << 16); }

// ---- phase A: check update of every check, in place
template <int MAXP, bool EXACT, int VEC, int METHOD>
__device__ __forceinline__ void bsr_checks(const BsrArgs& a, int it, float alpha) {
  const int Dc = EXACT ? MAXP : a.Dc;
  const size_t SS = (size_t)a.S;
  __nv_bfloat16* msg = (__nv_bfloat16*)a.msg;
  const float* prior = (const float*)a.prior;
  const float big = bf(BIG);
  RowItems items(a.C, a.S, VEC);
  int c, s0;
  while (items.next(c, s0, VEC)) {
    if (bsr_stopped(a, it, s0 / a.sb)) continue;
    const size_t e0 = (size_t)c * Dc;
    float x[VEC][MAXP];
    float t[VEC];
#pragma unroll
    for (int i = 0; i < MAXP; ++i) {
      if (i < Dc) {
        if (it == 0) {
          const int var = __ldg(&a.chk_vars[e0 + i]);
          const float x0 = var >= 0 ? bf(__ldg(&prior[var])) : big;
#pragma unroll
          for (int v = 0; v < VEC; ++v) x[v][i] = x0;
        } else {
          ld_bf16<VEC>(msg + (e0 + i) * SS + s0, t);
#pragma unroll
          for (int v = 0; v < VEC; ++v) x[v][i] = t[v];
        }
      }
    }
    const Pack<VEC> sy = ld_raw_ro<VEC>(a.synd + (size_t)c * SS + s0);
#pragma unroll
    for (int v = 0; v < VEC; ++v) check_update<MAXP>(x[v], Dc, sy.u8[v] ? -1.0f : 1.0f, METHOD, alpha);
    const int ns = __ldg(&a.nslot[c]);
    const bool raw = a.ablate == BSR_NO_ROUTE;   // c2v in every slot, for the copy grid
#pragma unroll
    for (int i = 0; i < MAXP; ++i) {
      if (i < Dc) {
        const int var = __ldg(&a.chk_vars[e0 + i]);
        // a live slot takes c2v; a padded one below nslot BIG - c2v; the
        // others keep +BIG, stored once in iteration 0
        if (var >= 0 || i < ns || it == 0 || raw) {
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            t[v] = var >= 0 || raw ? x[v][i] : (i < ns ? BIG - bf(x[v][i]) : BIG);
          st_bf16<VEC>(msg + (e0 + i) * SS + s0, t);
        }
      }
    }
  }
}

// ---- phase A of route "wide": checks of more than MAX_SLOTS slots (the
// fault matrices of detector error models), in two passes over the slots
// (WideCheck, spacetime_bp.cuh), so that what a thread holds does not grow
// with Dc; pass 2 reads each slot again, forms its outgoing message and
// stores it in place (a slot is read before it is written).
template <int VEC>
__device__ __forceinline__ void bsr_incoming(const BsrArgs& a, int it, size_t e, int var, int s0,
                                             float (&t)[VEC]) {
  if (it == 0) {  // iteration 0: the prior of the slot's variable, +BIG on a padded slot
    const float x0 = var >= 0 ? bf(__ldg(&((const float*)a.prior)[var])) : bf(BIG);
#pragma unroll
    for (int v = 0; v < VEC; ++v) t[v] = x0;
  } else {
    ld_bf16<VEC>((const __nv_bfloat16*)a.msg + e * a.S + s0, t);
  }
}

template <int VEC, int METHOD>
__device__ __forceinline__ void bsr_checks_wide(const BsrArgs& a, int it, float alpha) {
  const int Dc = a.Dc;
  __nv_bfloat16* msg = (__nv_bfloat16*)a.msg;
  RowItems items(a.C, a.S, VEC);
  int c, s0;
  while (items.next(c, s0, VEC)) {
    if (bsr_stopped(a, it, s0 / a.sb)) continue;
    const size_t e0 = (size_t)c * Dc;
    const Pack<VEC> sy = ld_raw_ro<VEC>(a.synd + (size_t)c * a.S + s0);
    WideCheck w[VEC];
    float t[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) w[v].init(sy.u8[v] ? -1.0f : 1.0f);
    for (int i = 0; i < Dc; ++i) {
      bsr_incoming<VEC>(a, it, e0 + i, __ldg(&a.chk_vars[e0 + i]), s0, t);
#pragma unroll
      for (int v = 0; v < VEC; ++v) w[v].fold(i, t[v], METHOD);
    }
    const int ns = __ldg(&a.nslot[c]);
    const bool raw = a.ablate == BSR_NO_ROUTE;
    for (int i = 0; i < Dc; ++i) {
      const int var = __ldg(&a.chk_vars[e0 + i]);
      // as phase A: a live slot takes c2v, a padded one below nslot BIG - c2v,
      // the others keep +BIG, stored once in iteration 0
      if (var < 0 && i >= ns && it > 0 && !raw) continue;
      bsr_incoming<VEC>(a, it, e0 + i, var, s0, t);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float out = w[v].out(i, t[v], METHOD, alpha);
        t[v] = var >= 0 || raw ? out : (i < ns ? BIG - bf(out) : BIG);
      }
      st_bf16<VEC>(msg + (e0 + i) * a.S + s0, t);
    }
  }
}

// ---- phase B: posterior (prior first, then the edges in order) and v2c.
// `out`: the posterior and the hard bytes of this iteration are read (the
// last iteration, or every one with the early exit).  DVR > 0 holds up to
// DVR edges' raw messages in registers; DVR = 0 reads them twice.
template <int VEC, int DVR>
__device__ __forceinline__ void bsr_vars(const BsrArgs& a, int it, bool out) {
  const int Dv = a.Dv;
  const size_t SS = (size_t)a.S;
  __nv_bfloat16* msg = (__nv_bfloat16*)a.msg;
  const float* prior = (const float*)a.prior;
  RowItems items(a.V, a.S, VEC);
  int u, s0;
  while (items.next(u, s0, VEC)) {
    if (bsr_stopped(a, it, s0 / a.sb)) continue;
    Pack<VEC> hd;
    if (out && u == 0) {  // conv starts at 1; phase C stores 0 on a violated check
#pragma unroll
      for (int v = 0; v < VEC; ++v) hd.u8[v] = 1;
      st_raw<VEC>(a.conv + s0, hd);
    }
    const int* edges = a.vm + (size_t)u * Dv;
    float total[VEC], pb[VEC], t[VEC];
    const float pr = __ldg(&prior[u]);
    // BSR_NO_CHECK: no grid A stored iteration 0's messages; they are bf16(prior)
    const bool init = a.ablate == BSR_NO_CHECK && it == 0;
    const uint16_t pr_bits = __bfloat16_as_ushort(__float2bfloat16_rn(pr));
#pragma unroll
    for (int v = 0; v < VEC; ++v) total[v] = pr;
    if (DVR > 0) {
      Pack<2 * VEC> m[DVR > 0 ? DVR : 1];
#pragma unroll
      for (int j = 0; j < DVR; ++j) {
        if (j < Dv) {
          const int k = __ldg(&edges[j]);
          if (k >= 0) {
            if (init) {
#pragma unroll
              for (int v = 0; v < VEC; ++v) m[j].u16[v] = pr_bits;
            } else {
              m[j] = ld_raw<2 * VEC>(msg + (size_t)k * SS + s0);
            }
#pragma unroll
            for (int v = 0; v < VEC; ++v) total[v] += bf16_bits(m[j].u16[v]);
          }
        }
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v) pb[v] = bf(total[v]);
#pragma unroll
      for (int j = 0; j < DVR; ++j) {
        if (j < Dv) {
          const int k = __ldg(&edges[j]);
          if (k >= 0) {
#pragma unroll
            for (int v = 0; v < VEC; ++v) t[v] = pb[v] - bf16_bits(m[j].u16[v]);
            st_bf16<VEC>(msg + (size_t)k * SS + s0, t);
          }
        }
      }
    } else {
      for (int j = 0; j < Dv; ++j) {
        const int k = __ldg(&edges[j]);
        if (k >= 0) {
          ld_bf16<VEC>(msg + (size_t)k * SS + s0, t);
#pragma unroll
          for (int v = 0; v < VEC; ++v) total[v] += init ? bf(pr) : t[v];
        }
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v) pb[v] = bf(total[v]);
      for (int j = 0; j < Dv; ++j) {
        const int k = __ldg(&edges[j]);
        if (k >= 0) {
          __nv_bfloat16* p = msg + (size_t)k * SS + s0;
          ld_bf16<VEC>(p, t);
#pragma unroll
          for (int v = 0; v < VEC; ++v) t[v] = pb[v] - (init ? bf(pr) : t[v]);
          st_bf16<VEC>(p, t);
        }
      }
    }
    if (out) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) hd.u8[v] = pb[v] <= 0.0f;
      st_raw<VEC>(a.hard + (size_t)u * SS + s0, hd);
      st_f32<VEC>((float*)a.post + (size_t)u * SS + s0, total);
    }
  }
}

// ---- BSR_NO_ROUTE's copy grid in place of phase B (the TPU kernel's
// copy-through stand-in, bp_bsr.py:413-423): rows 0..V-1 are the variables
// (posterior = prior and hard bytes 0 where they are read, so phase C finds
// parity 0 as the stand-in's zeroed accumulator), rows V..V+C-1 the checks
// (every slot's message negated, padded slots included).
template <int VEC>
__device__ __forceinline__ void bsr_copy(const BsrArgs& a, int it, bool out) {
  const size_t SS = (size_t)a.S;
  __nv_bfloat16* msg = (__nv_bfloat16*)a.msg;
  RowItems items(a.V + a.C, a.S, VEC);
  int r, s0;
  while (items.next(r, s0, VEC)) {
    if (bsr_stopped(a, it, s0 / a.sb)) continue;
    float t[VEC];
    if (r < a.V) {
      if (!out) continue;
      Pack<VEC> hd;
#pragma unroll
      for (int v = 0; v < VEC; ++v) hd.u8[v] = 1;
      if (r == 0) st_raw<VEC>(a.conv + s0, hd);   // as phase B: conv starts at 1
#pragma unroll
      for (int v = 0; v < VEC; ++v) hd.u8[v] = 0;
      st_raw<VEC>(a.hard + (size_t)r * SS + s0, hd);
      const float pr = __ldg(&((const float*)a.prior)[r]);
#pragma unroll
      for (int v = 0; v < VEC; ++v) t[v] = pr;
      st_f32<VEC>((float*)a.post + (size_t)r * SS + s0, t);
    } else {
      const size_t e0 = (size_t)(r - a.V) * a.Dc;
      for (int i = 0; i < a.Dc; ++i) {
        __nv_bfloat16* p = msg + (e0 + i) * SS + s0;
        ld_bf16<VEC>(p, t);
#pragma unroll
        for (int v = 0; v < VEC; ++v) t[v] = -t[v];
        st_bf16<VEC>(p, t);
      }
    }
  }
}

// One grid per phase; each first reads `done` and returns at once when it is set.
template <int MAXP, bool EXACT, int VEC, int METHOD>
__global__ void __launch_bounds__(ROW_THREADS, 2) bsr_bp_check_kernel(const BsrArgs a, int it,
                                                                      float alpha) {
  if (a.flags && a.flags[BSR_DONE]) return;
  bsr_checks<MAXP, EXACT, VEC, METHOD>(a, it, alpha);
}

template <int VEC, int METHOD>
__global__ void __launch_bounds__(ROW_THREADS) bsr_bp_check_wide_kernel(const BsrArgs a, int it,
                                                                       float alpha) {
  if (a.flags && a.flags[BSR_DONE]) return;
  bsr_checks_wide<VEC, METHOD>(a, it, alpha);
}

template <int VEC, int DVR>
__global__ void __launch_bounds__(ROW_THREADS) bsr_bp_var_kernel(const BsrArgs a, int it, bool out) {
  if (a.flags && a.flags[BSR_DONE]) return;
  bsr_vars<VEC, DVR>(a, it, out);
}

template <int VEC>
__global__ void __launch_bounds__(ROW_THREADS) bsr_bp_copy_kernel(const BsrArgs a, int it,
                                                                  bool out) {
  if (a.flags && a.flags[BSR_DONE]) return;
  bsr_copy<VEC>(a, it, out);
}

template <int VEC>
__global__ void __launch_bounds__(ROW_THREADS) bsr_bp_parity_kernel(const BsrArgs a, int it) {
  if (a.flags && a.flags[BSR_DONE]) return;
  bsr_parity<VEC>(a, it);
}

template <int MAXP, bool EXACT, int VEC>
static void launch_checks(const BsrArgs& a, int it, int method, float alpha, int blocks,
                          cudaStream_t st) {
  if (method == 0)
    bsr_bp_check_kernel<MAXP, EXACT, VEC, 0><<<blocks, ROW_THREADS, 0, st>>>(a, it, alpha);
  else
    bsr_bp_check_kernel<MAXP, EXACT, VEC, 1><<<blocks, ROW_THREADS, 0, st>>>(a, it, alpha);
}

// Phase A by check width and lane width: the main path's exact widths (7:
// HGP-225's H; 8: its (H|I); 24: the cyclic lifted product), every loop
// bound a constant, else the bounded scan up to 16 or 32 slots.  x[VEC][MAXP]
// lives in registers: 4 shots a lane up to 16 slots, 2 above, 1 where 4 or 2
// does not divide the shots and the shot block (the plan), as in K3.  Route
// "wide" (more than MAX_SLOTS slots): the two-pass scan, 8, 4, 2 or 1
// shots a lane.
static bool checks(const BsrArgs& a, int it, int vec, int method, float alpha, int blocks,
                   bool wide, cudaStream_t st) {
#define WIDE(VEC)                                                                          \
  if (vec == VEC) {                                                                        \
    if (method == 0)                                                                       \
      bsr_bp_check_wide_kernel<VEC, 0><<<blocks, ROW_THREADS, 0, st>>>(a, it, alpha);      \
    else                                                                                   \
      bsr_bp_check_wide_kernel<VEC, 1><<<blocks, ROW_THREADS, 0, st>>>(a, it, alpha);      \
    return true;                                                                           \
  }
#define CASE(MAXP, EXACT, VEC)                                              \
  if ((EXACT ? a.Dc == MAXP : a.Dc <= MAXP) && vec == VEC) {                \
    launch_checks<MAXP, EXACT, VEC>(a, it, method, alpha, blocks, st);      \
    return true;                                                            \
  }
  if (wide) {
    WIDE(1) WIDE(2) WIDE(4) WIDE(8)
    return false;
  }
  CASE(7, true, 1) CASE(7, true, 2) CASE(7, true, 4)
  CASE(8, true, 1) CASE(8, true, 2) CASE(8, true, 4)
  CASE(24, true, 1) CASE(24, true, 2)
  CASE(16, false, 1) CASE(16, false, 2) CASE(16, false, 4)
  CASE(32, false, 1) CASE(32, false, 2)
#undef CASE
#undef WIDE
  return false;
}

// Phase B by variable degree (edges held in registers: up to 8, up to 24,
// or none) and lane width.
static bool vars(const BsrArgs& a, int it, bool out, int vec, int blocks, cudaStream_t st) {
#define CASE(DVR, VEC)                                                       \
  if (vec == VEC) {                                                          \
    bsr_bp_var_kernel<VEC, DVR><<<blocks, ROW_THREADS, 0, st>>>(a, it, out); \
    return true;                                                             \
  }
  if (a.Dv <= 8) {
    CASE(8, 1) CASE(8, 2) CASE(8, 4) CASE(8, 8)
  } else if (a.Dv <= 24) {
    CASE(24, 1) CASE(24, 2) CASE(24, 4)
  } else {
    CASE(0, 1) CASE(0, 2) CASE(0, 4)
  }
#undef CASE
  return false;
}

// BSR_NO_ROUTE's copy grid, at phase B's lane width and grid.
static bool copy(const BsrArgs& a, int it, bool out, int vec, int blocks, cudaStream_t st) {
  switch (vec) {
    case 1: bsr_bp_copy_kernel<1><<<blocks, ROW_THREADS, 0, st>>>(a, it, out); return true;
    case 2: bsr_bp_copy_kernel<2><<<blocks, ROW_THREADS, 0, st>>>(a, it, out); return true;
    case 4: bsr_bp_copy_kernel<4><<<blocks, ROW_THREADS, 0, st>>>(a, it, out); return true;
    case 8: bsr_bp_copy_kernel<8><<<blocks, ROW_THREADS, 0, st>>>(a, it, out); return true;
    default: return false;
  }
}

static bool parity(const BsrArgs& a, int it, int vec, int blocks, cudaStream_t st) {
  switch (vec) {
    case 1: bsr_bp_parity_kernel<1><<<blocks, ROW_THREADS, 0, st>>>(a, it); return true;
    case 2: bsr_bp_parity_kernel<2><<<blocks, ROW_THREADS, 0, st>>>(a, it); return true;
    case 4: bsr_bp_parity_kernel<4><<<blocks, ROW_THREADS, 0, st>>>(a, it); return true;
    case 8: bsr_bp_parity_kernel<8><<<blocks, ROW_THREADS, 0, st>>>(a, it); return true;
    case 16: bsr_bp_parity_kernel<16><<<blocks, ROW_THREADS, 0, st>>>(a, it); return true;
    default: return false;
  }
}

// Route "coop": the whole decode in one cooperative launch whose blocks, all
// resident at once, separate the phases with grid-wide barriers instead of
// kernel boundaries (for decodes whose items fit one co-resident grid, where
// launches bound the time: the host redecode's few hundred shots).  The
// phases are the same device functions, so the results are the same bits.
// Min-sum on the main path's exact widths only (checks of 7 or 8 slots at 4
// shots a lane, variables of up to 8 edges at 8, parity at 16).
template <int MAXP>
__global__ void __launch_bounds__(ROW_THREADS, 2)
bsr_bp_coop_kernel(const BsrArgs a, float alpha, int adaptive, int n_iter) {
  cg::grid_group grid = cg::this_grid();
  const bool early = a.flags != nullptr;
  for (int it = 0; it < n_iter; ++it) {
    const float al = adaptive ? 1.0f - ldexpf(1.0f, -(it + 1)) : alpha;
    const bool out = early || it == n_iter - 1;
    bsr_checks<MAXP, true, 4, 1>(a, it, al);
    grid.sync();
    bsr_vars<8, 8>(a, it, out);
    grid.sync();
    if (out) bsr_parity<16>(a, it);
    // the next check phase touches nothing the parity phase reads; only the
    // early exit needs every block's verdict before it goes on
    if (early) {
      grid.sync();
      if (*(volatile int*)&a.flags[BSR_DONE]) break;  // the same word for every block
    }
  }
}

template <int MAXP>
static int launch_coop(const BsrArgs& a, float alpha, int adaptive, int n_iter, int blocks,
                       cudaStream_t st) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bsr_bp_coop_kernel<MAXP>, ROW_THREADS, 0);
  if (blocks > sms * per_sm) return (int)cudaErrorCooperativeLaunchTooLarge;
  BsrArgs args = a;
  void* params[] = {&args, &alpha, &adaptive, &n_iter};
  cudaLaunchCooperativeKernel((const void*)bsr_bp_coop_kernel<MAXP>, dim3(blocks),
                              dim3(ROW_THREADS), params, 0, st);
  return (int)cudaGetLastError();
}

// One whole decode of n_iter iterations (at most 3 grids each) on `stream`.
// method 0 = ps, 1 = ms; alpha the min-sum scaling, or with `adaptive`
// 1 - 2^-(it+1) per iteration.  gbad ((n_iter, G) int32, zeroed) and flags
// ((2,) int32, zeroed) are both given for the early exit and both null for
// fixed iterations.  vec_* / blocks_*: lane width and grid of each phase,
// planned by the caller (every vec divides S and sb; every array starts on
// a 16-byte boundary).  route: the plan's, BSR_GRIDS, BSR_COOP (one launch
// of the largest of the three grids, refused where the instance or the
// grid does not exist) or BSR_WIDE (required exactly where Dc exceeds
// MAX_SLOTS).  ablate: BSR_FULL, or the profiling hook's BSR_NO_CHECK /
// BSR_NO_ROUTE (never on route BSR_COOP).
extern "C" int bsr_bp_run(const void* chk_vars, const void* vm, const void* nslot,
                          const void* synd, const void* prior, void* msg, void* post, void* conv,
                          void* hard, void* gbad, void* flags, int C, int V, int Dc, int Dv,
                          int S, int S_live, int sb, int G, int method, float alpha, int adaptive,
                          int n_iter, int vec_a, int blocks_a, int vec_b, int blocks_b,
                          int vec_c, int blocks_c, int route, int ablate, void* stream) {
  const BsrArgs a = {(const int*)chk_vars, (const int*)vm, (const int*)nslot,
                     (const uint8_t*)synd, prior, msg, post, (uint8_t*)conv, (uint8_t*)hard,
                     (int*)gbad, (int*)flags, C, V, Dc, Dv, S, S_live, sb, G, ablate};
  if (!bsr_plan_ok(a, vec_a, vec_b, vec_c, route) || (gbad == nullptr) != (flags == nullptr) ||
      ablate < BSR_FULL || ablate > BSR_NO_ROUTE || (ablate != BSR_FULL && route == BSR_COOP))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (route == BSR_COOP) {
    const int ab = blocks_a > blocks_b ? blocks_a : blocks_b;
    const int blocks = ab > blocks_c ? ab : blocks_c;
    if (method != 1 || Dv > 8 || vec_a != 4 || vec_b != 8 || vec_c != 16)
      return (int)cudaErrorInvalidValue;
    if (Dc == 7) return launch_coop<7>(a, alpha, adaptive, n_iter, blocks, st);
    if (Dc == 8) return launch_coop<8>(a, alpha, adaptive, n_iter, blocks, st);
    return (int)cudaErrorInvalidValue;
  }
  const bool early = flags != nullptr;
  for (int it = 0; it < n_iter; ++it) {
    const float al = adaptive ? (float)(1.0 - ldexp(1.0, -(it + 1))) : alpha;
    const bool out = early || it == n_iter - 1;
    if ((ablate != BSR_NO_CHECK &&
         !checks(a, it, vec_a, method, al, blocks_a, route == BSR_WIDE, st)) ||
        !(ablate == BSR_NO_ROUTE ? copy(a, it, out, vec_b, blocks_b, st)
                                 : vars(a, it, out, vec_b, blocks_b, st)) ||
        (out && !parity(a, it, vec_c, blocks_c, st)))
      return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
