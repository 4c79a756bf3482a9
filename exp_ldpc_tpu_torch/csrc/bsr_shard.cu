// K4: one flooding BP iteration for one check shard (check-partition BP).
//
// Replaces exp_ldpc_tpu/decoders/bp_bsr_shard.py::_kernel_iter (the Pallas
// kernel launched by bsr_shard_iter).  Same contract, computed by
// bsr_shard_iter_plain in decoders/bp_bsr_shard.py, which is this kernel's
// plain version:
//   * inputs: the replicated posterior (V_pad, S) f32, this shard's c2v
//     messages of the previous iteration (e_loc, S) bf16 (zeros at
//     iteration 0) and its syndromes (c_pad_loc, S); edge rows are
//     slot-major, row = slot * c_pad_loc + local check;
//   * broadcast: v2c = bf16((live ? bf16(posterior[var]) : 1e30) - c2v);
//     for min-sum a slot at or past its 128-check chunk's live-slot count
//     (a plane with no edge) is pinned to bf16(1e30) and left out of the
//     scan; sum-product scans all Dc slots;
//   * check update in f32 (check_update in spacetime_bp.cuh), c2v stored
//     bf16 in place of the v2c;
//   * partials: per variable, the f32 sum of its local c2v messages in edge
//     order, grouped by 128-row edge tile as the TPU kernel's tile products
//     group them, with no prior; 0 for a variable with no local edge.  The
//     caller adds the prior after summing the shards' partials.
//
// What bounds it on an H100: each launch streams the posterior (4 B per
// variable per shot) and the shard's messages (2 B per edge slot, read and
// written) and partials (4 B per variable), through dependent gathers:
// memory latency and bandwidth, not arithmetic.  The shapes that need a
// check partition have many rows and few shots (n = 40,000 at 128 shots), so
// the rows, not the shots, must fill the card.
//
// Design.  Each phase is a flat list of (row, shot vector) items spread over
// a grid sized from the item count and the SM count; a thread owns VEC
// consecutive shots of one row (8- or 16-byte accesses) and its neighbours
// the next shots of that row, so warp accesses coalesce.  One iteration of
// one shard is two launches, the kernel boundary being the barrier between
// the blocks that share shots:
//   A  every local check: broadcast and check update, c2v stored in bf16;
//   B  every variable: the partial total of its local edges.  Either stored
//      (0 for a variable with no local edge), or, for the in-order sum of
//      several shards on one device, added to the running total in place
//      (a variable with no local edge is then left alone: + 0).
// Checks of more than MAX_SLOTS (32) slots (the fault matrices of detector
// error models) take route "wide": phase A in two passes over the slots,
// whose registers do not grow with Dc (bsr_shard_checks_wide); the caller's
// plan names the route and the entry point refuses one that does not match
// the degree.
// The all-reduce of the partials over the model axis runs between launches
// (no collective runs inside a kernel).  Each check and variable is computed
// by one thread in the plain version's order, so results are bit-identical.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bsr_shard_phases.cuh"

template <int MAXP, int VEC, int METHOD>
__global__ void __launch_bounds__(ROW_THREADS, 2) bsr_shard_check_kernel(const ShardArgs a,
                                                                      float alpha) {
  bsr_shard_checks<MAXP, VEC, METHOD>(a, alpha);
}

template <int VEC, int METHOD>
__global__ void __launch_bounds__(ROW_THREADS, 2) bsr_shard_check_wide_kernel(const ShardArgs a,
                                                                           float alpha) {
  bsr_shard_checks_wide<VEC, METHOD>(a, alpha);
}

template <int VEC, bool ACCUMULATE>
__global__ void __launch_bounds__(ROW_THREADS) bsr_shard_var_kernel(const ShardArgs a) {
  bsr_shard_vars<VEC, ACCUMULATE>(a);
}

template <int MAXP, int VEC>
static void launch_checks(const ShardArgs& a, int method, float alpha, int blocks,
                          cudaStream_t st) {
  if (method == 0)
    bsr_shard_check_kernel<MAXP, VEC, 0><<<blocks, ROW_THREADS, 0, st>>>(a, alpha);
  else
    bsr_shard_check_kernel<MAXP, VEC, 1><<<blocks, ROW_THREADS, 0, st>>>(a, alpha);
}

// Phase A by padded check width and lane width: 4 shots a lane up to 16
// slots, 2 above, 1 for a ragged S; x[VEC][MAXP] lives in registers, two
// blocks per SM (at most 128 registers a thread), as in K3.  Route "wide"
// (more than MAX_SLOTS slots): the two-pass scan, 8, 4, 2 or 1 shots a lane.
static bool checks(const ShardArgs& a, int vec, int method, float alpha, int blocks, bool wide,
                   cudaStream_t st) {
#define WIDE(VEC)                                                                        \
  if (vec == VEC) {                                                                      \
    if (method == 0)                                                                     \
      bsr_shard_check_wide_kernel<VEC, 0><<<blocks, ROW_THREADS, 0, st>>>(a, alpha);     \
    else                                                                                 \
      bsr_shard_check_wide_kernel<VEC, 1><<<blocks, ROW_THREADS, 0, st>>>(a, alpha);     \
    return true;                                                                         \
  }
  if (wide) {
    WIDE(1) WIDE(2) WIDE(4) WIDE(8)
    return false;
  }
#define CASE(MAXP, VEC)                                      \
  if (a.Dc <= MAXP && vec == VEC) {                          \
    launch_checks<MAXP, VEC>(a, method, alpha, blocks, st);  \
    return true;                                             \
  }
  CASE(8, 1) CASE(8, 4) CASE(12, 1) CASE(12, 4) CASE(16, 1) CASE(16, 4)
  CASE(24, 1) CASE(24, 2) CASE(32, 1) CASE(32, 2)
#undef CASE
#undef WIDE
  return false;
}

template <bool ACCUMULATE>
static bool vars(const ShardArgs& a, int vec, int blocks, cudaStream_t st) {
  if (vec == 1) bsr_shard_var_kernel<1, ACCUMULATE><<<blocks, ROW_THREADS, 0, st>>>(a);
  else if (vec == 2) bsr_shard_var_kernel<2, ACCUMULATE><<<blocks, ROW_THREADS, 0, st>>>(a);
  else if (vec == 4) bsr_shard_var_kernel<4, ACCUMULATE><<<blocks, ROW_THREADS, 0, st>>>(a);
  else if (vec == 8) bsr_shard_var_kernel<8, ACCUMULATE><<<blocks, ROW_THREADS, 0, st>>>(a);
  else return false;
  return true;
}

// One iteration of one shard (two launches) on `stream`.  With `accumulate`
// the partials are added to `part` in place.  vec_* / blocks_*: lane width
// and grid of each phase, planned by the caller (S a multiple of every vec,
// every array aligned to its access); `wide`: the check phase's route,
// "wide" exactly where Dc exceeds MAX_SLOTS.
extern "C" int bsr_shard(const void* chk_vars, const void* nslot, const void* lvar,
                         const void* lvm, const void* post, const void* msg_in, const void* synd,
                         void* msg_out, void* part, int Cl, int Dc, int V_pad, int n_loc, int Dv,
                         int S, int method, float alpha, int accumulate, int vec_a, int blocks_a,
                         int wide, int vec_b, int blocks_b, void* stream) {
  const ShardArgs a = {(const int*)chk_vars, (const int*)nslot, (const int*)lvar,
                       (const int*)lvm, (const float*)post, (const __nv_bfloat16*)msg_in,
                       (const uint8_t*)synd, (__nv_bfloat16*)msg_out, (float*)part,
                       Cl, Dc, V_pad, n_loc, Dv, S};
  cudaStream_t st = (cudaStream_t)stream;
  if (S % vec_a || S % vec_b || (wide != 0) != (Dc > MAX_SLOTS)) return (int)cudaErrorInvalidValue;
  if (!checks(a, vec_a, method, alpha, blocks_a, wide != 0, st)) return (int)cudaErrorInvalidValue;
  const bool ok = accumulate ? vars<true>(a, vec_b, blocks_b, st) : vars<false>(a, vec_b, blocks_b, st);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
