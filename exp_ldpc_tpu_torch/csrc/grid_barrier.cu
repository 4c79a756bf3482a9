// The barrier variant that K3 and K4 do NOT use, kept to be timed beside
// them (experiments/bench_grid_barrier.py): one cooperative launch whose
// blocks, all resident at once, separate the phases of an iteration (and,
// for K3, the iterations of a decode) with a grid-wide barrier
// (cooperative_groups::this_grid().sync()) instead of a kernel boundary.
// The phases are the device functions the kernels themselves run
// (stbsr_phases.cuh, bsr_shard_phases.cuh), so the results are the same
// bits.  A cooperative grid must fit the card at once: it is sized from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor, and one kernel holds the
// registers of its widest phase through all of them.  Min-sum only, at the
// lane widths the timed shapes use; no decoder calls this file.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bsr_shard_phases.cuh"
#include "stbsr_phases.cuh"

namespace cg = cooperative_groups;

template <int MAXP, int VA, int VB, int VC>
__global__ void __launch_bounds__(ROW_THREADS, 2)
stbsr_coop_kernel(const StArgs a, float alpha, int adaptive, int it0, int n_iter) {
  cg::grid_group grid = cg::this_grid();
  for (int it = it0; it < it0 + n_iter; ++it) {
    if (a.flags && *(volatile int*)&a.flags[F_DONE]) break;  // the same word for every block
    const float al = adaptive ? 1.0f - ldexpf(1.0f, -(it + 1)) : alpha;
    stbsr_checks<MAXP, VA, 1>(a, al);
    grid.sync();
    stbsr_vars<VB>(a, a.flags != nullptr || it == it0 + n_iter - 1);
    grid.sync();
    stbsr_parity<VC>(a);
    // the next check phase touches nothing the parity phase reads; only the
    // early exit needs every block's verdict before it goes on
    if (a.flags) grid.sync();
  }
}

template <int MAXP, int VA, int VB, bool ACCUMULATE>
__global__ void __launch_bounds__(ROW_THREADS, 2)
bsr_shard_coop_kernel(const ShardArgs a, float alpha) {
  bsr_shard_checks<MAXP, VA, 1>(a, alpha);
  cg::this_grid().sync();
  bsr_shard_vars<VB, ACCUMULATE>(a);
}

// Blocks of `kernel` that fit the card at once, capped at `want`.
template <typename K> static int resident_blocks(K kernel, int want) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, ROW_THREADS, 0);
  const int fit = sms * per_sm;
  return want < fit ? want : fit;
}

template <typename K> static int coop(K kernel, int want, void** params, cudaStream_t st) {
  const int blocks = resident_blocks(kernel, want);
  if (blocks < 1) return (int)cudaErrorLaunchOutOfResources;
  cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(ROW_THREADS), params, 0, st);
  return (int)cudaGetLastError();
}

// A whole K3 decode (n_iter iterations) in one cooperative launch; arguments
// as stbsr_run's, with `blocks` the largest grid any phase asked for.
extern "C" int stbsr_run_coop(const void* chk_vars, const void* vm, void* msg, void* mlo,
                              void* mhi, const void* synd, const void* prior_d,
                              const void* mprior, void* post_d, void* post_m, void* conv,
                              void* c2m, void* hard, void* flags, int r, int n, int Dc, int Dv,
                              int R, int S, int S_live, float alpha, int adaptive, int it0,
                              int n_iter, int vec_a, int vec_b, int vec_c, int blocks,
                              void* stream) {
  StArgs a = {(const int*)chk_vars, (const int*)vm, (__nv_bfloat16*)msg, (__nv_bfloat16*)mlo,
              (__nv_bfloat16*)mhi, (const uint8_t*)synd, (const float*)prior_d,
              (const float*)mprior, (float*)post_d, (float*)post_m, (uint8_t*)conv, (float*)c2m,
              (uint8_t*)hard, (int*)flags, r, n, Dc, Dv, R, S, S_live};
  void* params[] = {&a, &alpha, &adaptive, &it0, &n_iter};
  cudaStream_t st = (cudaStream_t)stream;
  const int P = Dc + 2;
  if (P <= 10 && vec_a == 4 && vec_b == 8 && vec_c == 16)
    return coop(stbsr_coop_kernel<10, 4, 8, 16>, blocks, params, st);
  if (P <= 28 && vec_a == 2 && vec_b == 8 && vec_c == 16)
    return coop(stbsr_coop_kernel<28, 2, 8, 16>, blocks, params, st);
  return (int)cudaErrorInvalidValue;
}

// One K4 iteration of one shard in one cooperative launch; arguments as
// bsr_shard's, with `blocks` the larger of the two phases' grids.
extern "C" int bsr_shard_coop(const void* chk_vars, const void* nslot, const void* lvar,
                              const void* lvm, const void* post, const void* msg_in,
                              const void* synd, void* msg_out, void* part, int Cl, int Dc,
                              int V_pad, int n_loc, int Dv, int S, float alpha, int accumulate,
                              int vec_a, int vec_b, int blocks, void* stream) {
  ShardArgs a = {(const int*)chk_vars, (const int*)nslot, (const int*)lvar, (const int*)lvm,
                 (const float*)post, (const __nv_bfloat16*)msg_in, (const uint8_t*)synd,
                 (__nv_bfloat16*)msg_out, (float*)part, Cl, Dc, V_pad, n_loc, Dv, S};
  void* params[] = {&a, &alpha};
  cudaStream_t st = (cudaStream_t)stream;
  if (Dc <= 8 && vec_a == 4 && vec_b == 8)
    return accumulate ? coop(bsr_shard_coop_kernel<8, 4, 8, true>, blocks, params, st)
                      : coop(bsr_shard_coop_kernel<8, 4, 8, false>, blocks, params, st);
  if (Dc <= 24 && vec_a == 2 && vec_b == 8)
    return accumulate ? coop(bsr_shard_coop_kernel<24, 2, 8, true>, blocks, params, st)
                      : coop(bsr_shard_coop_kernel<24, 2, 8, false>, blocks, params, st);
  return (int)cudaErrorInvalidValue;
}
