// Shared device code of the flat BP kernels K1 (bsr_bp.cu, bf16 messages)
// and K5 (bsr_bp_int8.cu, int8 fixed point): the arguments of one decode,
// the per-shot-block exit test, phase C (the parity of every check from the
// hard-decision bytes, with the early exit's flags) and the plan's checks.
// Each file wraps the phases in kernels of its own names, so a trace tells
// the two apart.  Each phase walks a flat (row, shot vector) work list with
// the whole grid (vec_io.cuh).  Arrays that a decode writes are read with
// plain loads, never through the read-only cache.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "spacetime_bp.cuh"
#include "vec_io.cuh"

enum { BSR_DONE = 0, BSR_TICKET = 1 };
// The plan's routes (utils/cuda_build.py::bsr_plan): one grid per phase; K1's
// one cooperative launch; one grid per phase with the two-pass check phase
// for checks of more than MAX_SLOTS slots (spacetime_bp.cuh), whose
// register instances stop there.
enum { BSR_GRIDS = 0, BSR_COOP = 1, BSR_WIDE = 2 };

struct BsrArgs {
  const int* chk_vars;   // (C*Dc,) variable of each check-major slot, -1 = padded slot
  const int* vm;         // (V*Dv,) check-major slot of each variable's edge, -1 = pad
  const int* nslot;      // (C,) K1: padded slots below this are rewritten (K5: unused)
  const uint8_t* synd;   // (C, S)
  const void* prior;     // (V,) K1: f32 LLRs; K5: int32 quanta
  void* msg;             // (C*Dc, S) v2c, K1 bf16, K5 int8; updated in place
  void* post;            // (V, S) out, K1 f32, K5 int32 quanta
  uint8_t* conv;         // (S,) out
  uint8_t* hard;         // (V, S) scratch: the hard decision phase C reads
  int* gbad;             // (max_iter, G) "a live shot of block g failed after iteration it";
                         // null in fixed-iteration mode
  int* flags;            // (2,) done, ticket; null in fixed-iteration mode
  int C, V, Dc, Dv;
  int S;                 // shots of every array (a multiple of every phase's VEC)
  int S_live;            // the caller's shots; the padded ones never count towards the exit
  int sb, G;             // shots per exit block (a multiple of every VEC), blocks of S
  int ablate;            // K1's profiling hook (bsr_bp.cu: BSR_FULL, BSR_NO_CHECK, BSR_NO_ROUTE); K5: 0
};

// Shot block g stopped before iteration it: its last iteration left no live
// shot unconverged.  A stopped block's items do nothing.
__device__ __forceinline__ bool bsr_stopped(const BsrArgs& a, int it, int g) {
  return a.gbad != nullptr && it > 0 && a.gbad[(size_t)(it - 1) * a.G + g] == 0;
}

// ---- phase C: parity of every check from the hard bytes phase B wrote;
// conv starts at 1 (set in phase B) and a violated check stores 0.  With the
// early exit a violated check of a live shot marks its shot block in
// gbad[it]; the last block of the grid to finish (a ticket counter) sets
// `done` when no shot block is marked, and every later grid of the decode
// returns at once.
template <int VEC>
__device__ __forceinline__ void bsr_parity(const BsrArgs& a, int it) {
  const int Dc = a.Dc;
  const size_t SS = (size_t)a.S;
  int* gbad_it = a.gbad == nullptr ? nullptr : a.gbad + (size_t)it * a.G;
  RowItems items(a.C, a.S, VEC);
  int c, s0;
  while (items.next(c, s0, VEC)) {
    const int g = s0 / a.sb;
    if (bsr_stopped(a, it, g)) continue;
    Pack<VEC> par = ld_raw_ro<VEC>(a.synd + (size_t)c * SS + s0);
    for (int i = 0; i < Dc; ++i) {
      const int v = __ldg(&a.chk_vars[c * Dc + i]);
      if (v >= 0) xor_into<VEC>(par, ld_raw<VEC>(a.hard + (size_t)v * SS + s0));
    }
    bool bad = false;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      if (par.u8[v]) {
        a.conv[s0 + v] = 0;
        if (s0 + v < a.S_live) bad = true;
      }
    }
    // a plain read first: most items of a failing block find the mark set
    if (bad && gbad_it != nullptr && *(volatile int*)&gbad_it[g] == 0) atomicOr(&gbad_it[g], 1);
  }
  if (a.flags == nullptr) return;  // uniform: every thread of the grid sees the same pointer
  // Every thread's marks are visible device-wide before its block takes a
  // ticket, so the holder of the last ticket sees them all.
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&a.flags[BSR_TICKET], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  int any = 0;
  for (int g = threadIdx.x; g < a.G; g += blockDim.x) any |= *(volatile int*)&gbad_it[g];
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) {
    a.flags[BSR_TICKET] = 0;
    if (!any) a.flags[BSR_DONE] = 1;
  }
}

// The plan's checks, shared by both entry points: every phase's lane width
// divides the shot count and the shot block (no item straddles two blocks),
// the blocks cover the shots, and the route is "wide" exactly where the
// checks are wider than the register instances.
static bool bsr_plan_ok(const BsrArgs& a, int vec_a, int vec_b, int vec_c, int route) {
  const int vecs[3] = {vec_a, vec_b, vec_c};
  for (int i = 0; i < 3; ++i)
    if (vecs[i] < 1 || a.S % vecs[i] || a.sb % vecs[i]) return false;
  return a.S_live >= 1 && a.S_live <= a.S && a.sb >= 1 && (size_t)a.G * a.sb >= (size_t)a.S &&
         a.Dc >= 1 && (route == BSR_WIDE) == (a.Dc > MAX_SLOTS);
}
