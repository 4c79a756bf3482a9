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
//     it is taken every iteration and a shot block whose shots all pass
//     stops: the JAX kernel resets its done flag per grid step, so the exit
//     unit is its block of shot_block shots (128 or 256), not the batch.
//
// What bounds it on an H100: every iteration streams each bf16 message of
// each shot through device memory twice, plus the f32 posterior, and each
// update is a short dependent chain of loads: memory latency and bandwidth,
// not arithmetic.  The TPU kernel keeps a shot block's state in VMEM and
// routes it with one-hot 128x128 tiles on the matrix unit; neither carries
// over.  Design (as K2/K3): a block owns 32 shots (one per lane, so every
// warp access is 32 consecutive shots of one row: coalesced) and its 8 warps
// split each phase (A: checks, B: variables, C: parity) with block barriers;
// the Tanner tables are read through the read-only cache.
//
// The early exit spans CUDA blocks: a JAX shot block of 128-256 shots is
// 4-8 blocks of 32 here, and blocks cannot wait for each other inside one
// launch.  So with early_stop the caller launches once per iteration, and
// gbad[it][g] (zeroed by the caller) collects "some shot of shot block g
// failed its parity after iteration it"; at the next launch a lane whose
// shot block left no shot unconverged does nothing, and a block whose lanes
// all do nothing returns at once.  Without early_stop there is no exit and
// all iterations run in one launch.  Each check, variable and parity is
// computed by one thread in the plain version's order, so results are
// bit-identical to it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "spacetime_bp.cuh"

__device__ __forceinline__ float bf(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

template <int MAXP>
__global__ void __launch_bounds__(LANES* WORKERS) bsr_bp_kernel(
    const int* __restrict__ chk_vars,   // (C*Dc,), -1 = padded slot
    const int* __restrict__ vm,         // (V*Dv,), flat check-major slot, -1 = pad
    const int* __restrict__ nslot,      // (C,) padded slots below this are rewritten
    const uint8_t* __restrict__ synd,   // (C, S)
    const float* __restrict__ prior,    // (V,)
    __nv_bfloat16* __restrict__ msg,    // (C*Dc, S) v2c, kept across launches
    float* __restrict__ post,           // (V, S) out
    uint8_t* __restrict__ conv,         // (S,) out
    int* __restrict__ gbad,             // (max_iter, G) per-shot-block "unconverged"
    int C, int V, int Dc, int Dv, int S, int it0, int n_it, int max_iter, int method,
    int early_stop, int shot_block, int G, float alpha0) {
  __shared__ int bad[LANES];
  const int lane = threadIdx.x;
  const int w = threadIdx.y;
  const int s = blockIdx.x * LANES + lane;
  const int g = s / shot_block;
  bool run = s < S;
  // a shot block that left no shot unconverged last iteration has stopped
  if (run && early_stop && it0 > 0) run = gbad[(size_t)(it0 - 1) * G + g] != 0;
  if (!__syncthreads_or(run)) return;
  const size_t SS = (size_t)S;
  if (w == 0) bad[lane] = 0;

  if (run && it0 == 0) {  // init: v2c = bf16(prior[var]), padded slots bf16(+BIG)
    for (int e = w; e < C * Dc; e += WORKERS) {
      const int v = __ldg(&chk_vars[e]);
      msg[(size_t)e * SS + s] = __float2bfloat16_rn(v >= 0 ? __ldg(&prior[v]) : BIG);
    }
  }
  __syncthreads();

  for (int it = it0; it < it0 + n_it; ++it) {
    const float alpha = (alpha0 == 0.0f) ? 1.0f - ldexpf(1.0f, -(it + 1)) : alpha0;
    const bool write_post = early_stop || it == max_iter - 1;
    // ---- phase A: check update of every check, in place
    if (run) {
      for (int c = w; c < C; c += WORKERS) {
        float x[MAXP];
        const size_t e0 = (size_t)c * Dc;
#pragma unroll
        for (int i = 0; i < MAXP; ++i)
          if (i < Dc) x[i] = __bfloat162float(msg[(e0 + i) * SS + s]);
        const float ss = synd[(size_t)c * SS + s] ? -1.0f : 1.0f;
        check_update<MAXP>(x, Dc, ss, method, alpha);
        const int ns = __ldg(&nslot[c]);
#pragma unroll
        for (int i = 0; i < MAXP; ++i) {
          if (i < Dc) {
            if (__ldg(&chk_vars[e0 + i]) >= 0)
              msg[(e0 + i) * SS + s] = __float2bfloat16_rn(x[i]);
            else if (i < ns)
              msg[(e0 + i) * SS + s] = __float2bfloat16_rn(BIG - bf(x[i]));
          }
        }
      }
    }
    __syncthreads();
    // ---- phase B: posterior (prior first, then edges in order) and v2c
    if (run) {
      for (int v = w; v < V; v += WORKERS) {
        float total = __ldg(&prior[v]);
        for (int j = 0; j < Dv; ++j) {
          const int k = __ldg(&vm[v * Dv + j]);
          if (k >= 0) total += __bfloat162float(msg[(size_t)k * SS + s]);
        }
        if (write_post) post[(size_t)v * SS + s] = total;
        const float pb = bf(total);
        for (int j = 0; j < Dv; ++j) {
          const int k = __ldg(&vm[v * Dv + j]);
          if (k >= 0) {
            const size_t idx = (size_t)k * SS + s;
            msg[idx] = __float2bfloat16_rn(pb - __bfloat162float(msg[idx]));
          }
        }
      }
    }
    __syncthreads();
  }

  // ---- phase C: parity of bf16(posterior) after the launch's last iteration
  int any = 0;
  if (run) {
    for (int c = w; c < C; c += WORKERS) {
      int par = synd[(size_t)c * SS + s];
      for (int i = 0; i < Dc; ++i) {
        const int v = __ldg(&chk_vars[c * Dc + i]);
        if (v >= 0) par ^= (bf(post[(size_t)v * SS + s]) <= 0.0f);
      }
      any |= par;
    }
  }
  if (any) atomicOr(&bad[lane], 1);
  __syncthreads();
  if (run && w == 0) {
    conv[s] = bad[lane] ? 0 : 1;
    if (early_stop && bad[lane]) atomicOr(&gbad[(size_t)(it0 + n_it - 1) * G + g], 1);
  }
}

template <int MAXP>
static int launch(const int* chk_vars, const int* vm, const int* nslot, const uint8_t* synd,
                  const float* prior, __nv_bfloat16* msg, float* post, uint8_t* conv, int* gbad,
                  int C, int V, int Dc, int Dv, int S, int it0, int n_it, int max_iter,
                  int method, int early_stop, int shot_block, int G, float alpha0,
                  cudaStream_t stream) {
  const dim3 threads(LANES, WORKERS);
  const int blocks = (S + LANES - 1) / LANES;
  bsr_bp_kernel<MAXP><<<blocks, threads, 0, stream>>>(
      chk_vars, vm, nslot, synd, prior, msg, post, conv, gbad, C, V, Dc, Dv, S, it0, n_it,
      max_iter, method, early_stop, shot_block, G, alpha0);
  return (int)cudaGetLastError();
}

extern "C" int bsr_bp(const void* chk_vars, const void* vm, const void* nslot, const void* synd,
                      const void* prior, void* msg, void* post, void* conv, void* gbad, int C,
                      int V, int Dc, int Dv, int S, int it0, int n_it, int max_iter, int method,
                      int early_stop, int shot_block, int G, float alpha0, void* stream) {
  auto args = [&](auto f) {
    return f((const int*)chk_vars, (const int*)vm, (const int*)nslot, (const uint8_t*)synd,
             (const float*)prior, (__nv_bfloat16*)msg, (float*)post, (uint8_t*)conv, (int*)gbad,
             C, V, Dc, Dv, S, it0, n_it, max_iter, method, early_stop, shot_block, G, alpha0,
             (cudaStream_t)stream);
  };
  if (Dc <= 8) return args([](auto... a) { return launch<8>(a...); });
  if (Dc <= 16) return args([](auto... a) { return launch<16>(a...); });
  if (Dc <= 32) return args([](auto... a) { return launch<32>(a...); });
  return (int)cudaErrorInvalidValue;
}
