// K3: flooding iterations of spacetime BP with bf16 messages.
//
// Replaces exp_ldpc_tpu/decoders/bp_bsr_spacetime.py::_st_kernel_iter (the
// streamed spacetime BSR kernel launched by stbsr_decode).  Same contract,
// computed by _stbsr_iter_plain in decoders/bp_bsr_spacetime.py, which is
// this kernel's plain version:
//   * messages are bf16 in device memory, updated in place across launches
//     (the TPU kernel aliases them in and out); every sum is f32;
//   * rounding points: check->data messages are stored in bf16; the two
//     check->measurement messages stay f32 inside the iteration; the
//     measurement posterior is f32 and its two outgoing messages are stored
//     in bf16; the data posterior is f32, rounded to bf16 before the edge
//     broadcast and before its hard decision enters the parity;
//   * measurement variables (degree 2) update in closed form;
//   * conv[s] is the exact spacetime syndrome check of the estimate of the
//     last iteration that ran;
//   * the early exit is GLOBAL: the decode stops after the first iteration
//     whose estimate satisfies every shot's syndrome, and nothing is
//     touched after it.
//
// What bounds it on an H100: an iteration streams the whole message state
// of every shot through device memory (for 4-round HGP-225: 3.8k bf16 data
// messages read and written twice, plus the f32 posteriors, ~40 KB per shot
// per iteration) in short dependent chains of gathers: memory latency and
// bandwidth, not arithmetic.  Two things decide its time: how many loads
// the card has in flight, and how many bytes each carries.
//
// Design.  The work of a phase is a flat list of (row, shot vector) items
// spread over a grid sized from the item count and the SM count, so a
// decode of 128 shots x 43,000 spacetime checks fills the card as a decode
// of 16,384 shots x 540 does.  A thread owns VEC consecutive shots of one
// row (one 8- or 16-byte access of the bf16, f32 and byte arrays); its
// neighbours own the next shots of the same row, so warp accesses coalesce.
// An iteration is three launches, the kernel boundary being the barrier
// between blocks that share shots:
//   A  every check of every round block: check update; data messages back
//      to msg in bf16, the two measurement messages to the f32 scratch c2m;
//   B  every measurement variable (closed form) and every data variable
//      (its messages gathered once and held in registers): outgoing
//      messages, the hard decision as one byte per variable, and the f32
//      posteriors (in fixed-iteration mode only in the last iteration: they
//      are outputs, nothing reads them back);
//   C  every parity check, from those bytes: conv[s] starts at 1 (set in B)
//      and any violated check stores 0.
// The iteration loop runs in the C entry point: one call enqueues all
// iterations.  With the early exit every kernel first reads a `done` word
// in device memory and returns at once when it is set; the last block of
// phase C to finish (a ticket counter) sets it when no live shot had a
// violated check, and counts the iteration in the device-side `iters`.  The
// host reads nothing during the loop.  In fixed-iteration mode the flags
// pointer is null and no flag traffic exists.
// Checks of more than MAX_SLOTS (32) slots, data and measurement slots
// together (Dc > 30, as in dense hypergraph products), take route "wide":
// phase A in two passes over the slots, whose registers do not grow with Dc
// (stbsr_checks_wide); the caller's plan names the route and the entry point
// refuses one that does not match the degree.
// The Tanner tables (identical for all threads of a row) come through the
// read-only cache; the TPU's 128x128 one-hot tiles have no counterpart.
// Each check, variable and parity is computed by one thread in the plain
// version's order, so results are bit-identical to it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "stbsr_phases.cuh"

// One launch per phase.  With the early exit every launch first reads the
// `done` word and returns at once when it is set.
template <int MAXP, int VEC, int METHOD>
__global__ void __launch_bounds__(ROW_THREADS, 2) stbsr_check_kernel(const StArgs a, float alpha) {
  if (a.flags && a.flags[F_DONE]) return;
  stbsr_checks<MAXP, VEC, METHOD>(a, alpha);
}

template <int VEC, int METHOD>
__global__ void __launch_bounds__(ROW_THREADS, 2) stbsr_check_wide_kernel(const StArgs a,
                                                                       float alpha) {
  if (a.flags && a.flags[F_DONE]) return;
  stbsr_checks_wide<VEC, METHOD>(a, alpha);
}

template <int VEC>
__global__ void __launch_bounds__(ROW_THREADS) stbsr_var_kernel(const StArgs a, bool write_post) {
  if (a.flags && a.flags[F_DONE]) return;
  stbsr_vars<VEC>(a, write_post);
}

template <int VEC>
__global__ void __launch_bounds__(ROW_THREADS) stbsr_parity_kernel(const StArgs a) {
  if (a.flags && a.flags[F_DONE]) return;
  stbsr_parity<VEC>(a);
}

template <int MAXP, int VEC>
static void launch_checks(const StArgs& a, int method, float alpha, int blocks, cudaStream_t st) {
  if (method == 0)
    stbsr_check_kernel<MAXP, VEC, 0><<<blocks, ROW_THREADS, 0, st>>>(a, alpha);
  else
    stbsr_check_kernel<MAXP, VEC, 1><<<blocks, ROW_THREADS, 0, st>>>(a, alpha);
}

// Phase A by padded check width and lane width: 4 shots a lane up to 16
// slots, 2 above, 1 for a ragged S.  x[VEC][MAXP] lives in registers, and
// two blocks per SM (at most 128 registers a thread) measured faster than
// one block with more registers or three with spills.  Route "wide" (more
// than MAX_SLOTS slots): the two-pass scan, 8, 4, 2 or 1 shots a lane.
static bool checks(const StArgs& a, int vec, int method, float alpha, int blocks, bool wide,
                   cudaStream_t st) {
  const int P = a.Dc + 2;
#define WIDE(VEC)                                                                      \
  if (vec == VEC) {                                                                    \
    if (method == 0)                                                                   \
      stbsr_check_wide_kernel<VEC, 0><<<blocks, ROW_THREADS, 0, st>>>(a, alpha);       \
    else                                                                               \
      stbsr_check_wide_kernel<VEC, 1><<<blocks, ROW_THREADS, 0, st>>>(a, alpha);       \
    return true;                                                                       \
  }
#define CASE(MAXP, VEC)                                      \
  if (P <= MAXP && vec == VEC) {                             \
    launch_checks<MAXP, VEC>(a, method, alpha, blocks, st);  \
    return true;                                             \
  }
  if (wide) {
    WIDE(1) WIDE(2) WIDE(4) WIDE(8)
    return false;
  }
  CASE(8, 1) CASE(8, 4) CASE(10, 1) CASE(10, 4) CASE(12, 1) CASE(12, 4) CASE(16, 1) CASE(16, 4)
  CASE(24, 1) CASE(24, 2) CASE(28, 1) CASE(28, 2) CASE(32, 1) CASE(32, 2)
#undef CASE
#undef WIDE
  return false;
}

static bool vars(const StArgs& a, int vec, bool write_post, int blocks, cudaStream_t st) {
  if (vec == 1) stbsr_var_kernel<1><<<blocks, ROW_THREADS, 0, st>>>(a, write_post);
  else if (vec == 2) stbsr_var_kernel<2><<<blocks, ROW_THREADS, 0, st>>>(a, write_post);
  else if (vec == 4) stbsr_var_kernel<4><<<blocks, ROW_THREADS, 0, st>>>(a, write_post);
  else if (vec == 8) stbsr_var_kernel<8><<<blocks, ROW_THREADS, 0, st>>>(a, write_post);
  else return false;
  return true;
}

static bool parity(const StArgs& a, int vec, int blocks, cudaStream_t st) {
  if (vec == 1) stbsr_parity_kernel<1><<<blocks, ROW_THREADS, 0, st>>>(a);
  else if (vec == 4) stbsr_parity_kernel<4><<<blocks, ROW_THREADS, 0, st>>>(a);
  else if (vec == 8) stbsr_parity_kernel<8><<<blocks, ROW_THREADS, 0, st>>>(a);
  else if (vec == 16) stbsr_parity_kernel<16><<<blocks, ROW_THREADS, 0, st>>>(a);
  else return false;
  return true;
}

// Runs iterations it0 .. it0 + n_iter - 1 (three launches each) on `stream`.
// alpha: the min-sum scaling, or with `adaptive` 1 - 2^-(it+1) per iteration.
// vec_* / blocks_*: lane width and grid of each phase, planned by the caller
// (S a multiple of every vec, every array aligned to its access); `wide`: the
// check phase's route, "wide" exactly where Dc + 2 exceeds MAX_SLOTS.
extern "C" int stbsr_run(const void* chk_vars, const void* vm, void* msg, void* mlo, void* mhi,
                         const void* synd, const void* prior_d, const void* mprior, void* post_d,
                         void* post_m, void* conv, void* c2m, void* hard, void* flags, int r,
                         int n, int Dc, int Dv, int R, int S, int S_live, int method, float alpha,
                         int adaptive, int it0, int n_iter, int vec_a, int blocks_a, int wide,
                         int vec_b, int blocks_b, int vec_c, int blocks_c, void* stream) {
  const StArgs a = {(const int*)chk_vars, (const int*)vm, (__nv_bfloat16*)msg,
                    (__nv_bfloat16*)mlo, (__nv_bfloat16*)mhi, (const uint8_t*)synd,
                    (const float*)prior_d, (const float*)mprior, (float*)post_d, (float*)post_m,
                    (uint8_t*)conv, (float*)c2m, (uint8_t*)hard, (int*)flags,
                    r, n, Dc, Dv, R, S, S_live};
  cudaStream_t st = (cudaStream_t)stream;
  if (S % vec_a || S % vec_b || S % vec_c || (wide != 0) != (Dc + 2 > MAX_SLOTS))
    return (int)cudaErrorInvalidValue;
  for (int it = it0; it < it0 + n_iter; ++it) {
    const float al = adaptive ? (float)(1.0 - ldexp(1.0, -(it + 1))) : alpha;
    // the posteriors are outputs only: with a fixed count the last iteration's are the
    // ones returned; with the early exit any iteration may be the last
    const bool write_post = flags != nullptr || it == it0 + n_iter - 1;
    if (!checks(a, vec_a, method, al, blocks_a, wide != 0, st) ||
        !vars(a, vec_b, write_post, blocks_b, st) ||
        !parity(a, vec_c, blocks_c, st))
      return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
