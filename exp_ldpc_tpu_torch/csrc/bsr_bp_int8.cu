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
//     is taken every iteration and a shot block whose shots all pass stops
//     (the JAX kernel resets its done flag per grid step, so the exit unit is
//     its block of shot_block shots, as in K1).
// Integer sums do not depend on their order, so the results equal the plain
// version's, and the reference's in fixed-iteration mode, bit for bit.
//
// What bounds it on an H100: as K1, every iteration streams each message of
// each shot through device memory twice plus the int32 posterior, in short
// dependent chains of loads; and the traffic is byte-wide: a warp that reads
// 32 consecutive int8 shots of a row touches 32 bytes, a quarter of a
// 128-byte line, so the memory system moves lines that are mostly unused
// within one access (neighbouring blocks use the rest).  The TPU kernel keeps
// a shot block's messages in VMEM and routes them with one-hot 128x128 int8
// tiles on the matrix unit; its dead-row value, live-slot plane skipping and
// one-hot scratch are devices of that layout and are not carried over.
// Design (K1's): a block owns 32 shots (one per lane), its 8 warps split each
// phase (A: checks, B: variables, C: parity) with block barriers, and the
// Tanner tables are read through the read-only cache.  Packing four shots per
// lane (char4 and the byte-wise SIMD intrinsics) would use whole lines; this
// kernel does not do it.
//
// The early exit spans CUDA blocks as in K1 (bsr_bp.cu): with early_stop the
// caller launches once per iteration, and gbad[it][g] (zeroed by the caller)
// collects "some shot of shot block g failed its parity after iteration it";
// at the next launch a lane whose shot block left no shot unconverged does
// nothing.  Without early_stop all iterations run in one launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "spacetime_bp.cuh"

#define SAT 127

__device__ __forceinline__ int clip_sat(int x) { return min(max(x, -SAT), SAT); }

template <int MAXP>
__global__ void __launch_bounds__(LANES* WORKERS) bsr_bp_int8_kernel(
    const int* __restrict__ chk_vars,   // (C*Dc,), -1 = padded slot
    const int* __restrict__ vm,         // (V*Dv,), flat check-major slot, -1 = pad
    const uint8_t* __restrict__ synd,   // (C, S)
    const int* __restrict__ prior_q,    // (V,) quanta
    int8_t* __restrict__ msg,           // (C*Dc, S) v2c, kept across launches
    int* __restrict__ post,             // (V, S) out, quanta
    uint8_t* __restrict__ conv,         // (S,) out
    int* __restrict__ gbad,             // (max_iter, G) per-shot-block "unconverged"
    int C, int V, int Dc, int Dv, int S, int it0, int n_it, int max_iter, int alpha_num,
    int early_stop, int shot_block, int G) {
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

  if (run && it0 == 0) {  // init: v2c = saturated prior of the edge's variable, pads +SAT
    for (int e = w; e < C * Dc; e += WORKERS) {
      const int v = __ldg(&chk_vars[e]);
      msg[(size_t)e * SS + s] = (int8_t)(v >= 0 ? clip_sat(__ldg(&prior_q[v])) : SAT);
    }
  }
  __syncthreads();

  for (int it = it0; it < it0 + n_it; ++it) {
    const bool write_post = early_stop || it == max_iter - 1;
    // ---- phase A: check update of every check, in place on its live slots
    if (run) {
      for (int c = w; c < C; c += WORKERS) {
        int x[MAXP];
        const size_t e0 = (size_t)c * Dc;
#pragma unroll
        for (int i = 0; i < MAXP; ++i)
          if (i < Dc) x[i] = msg[(e0 + i) * SS + s];
        int neg_tot = synd[(size_t)c * SS + s];
        int min1 = abs(x[0]), min2 = SAT + 1, arg = 0;
        neg_tot += x[0] < 0;
#pragma unroll
        for (int i = 1; i < MAXP; ++i) {
          if (i < Dc) {
            neg_tot += x[i] < 0;
            const int m = abs(x[i]);
            if (m < min1) {
              min2 = min1;
              min1 = m;
              arg = i;
            } else {
              min2 = min(min2, m);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < MAXP; ++i) {
          if (i < Dc && __ldg(&chk_vars[e0 + i]) >= 0) {
            const int scaled = (((i == arg) ? min2 : min1) * alpha_num) >> 8;
            const bool ext_neg = (neg_tot + (x[i] < 0)) & 1;
            msg[(e0 + i) * SS + s] = (int8_t)(ext_neg ? -scaled : scaled);
          }
        }
      }
    }
    __syncthreads();
    // ---- phase B: posterior and the new v2c of every variable
    if (run) {
      for (int v = w; v < V; v += WORKERS) {
        int total = __ldg(&prior_q[v]);
        for (int j = 0; j < Dv; ++j) {
          const int k = __ldg(&vm[v * Dv + j]);
          if (k >= 0) total += msg[(size_t)k * SS + s];
        }
        if (write_post) post[(size_t)v * SS + s] = total;
        const int p8 = clip_sat(total);
        for (int j = 0; j < Dv; ++j) {
          const int k = __ldg(&vm[v * Dv + j]);
          if (k >= 0) {
            const size_t idx = (size_t)k * SS + s;
            msg[idx] = (int8_t)clip_sat(p8 - (int)msg[idx]);
          }
        }
      }
    }
    __syncthreads();
  }

  // ---- phase C: parity of the posterior after the launch's last iteration
  int any = 0;
  if (run) {
    for (int c = w; c < C; c += WORKERS) {
      int par = synd[(size_t)c * SS + s];
      for (int i = 0; i < Dc; ++i) {
        const int v = __ldg(&chk_vars[c * Dc + i]);
        if (v >= 0) par ^= (post[(size_t)v * SS + s] <= 0);
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
static int launch(const int* chk_vars, const int* vm, const uint8_t* synd, const int* prior_q,
                  int8_t* msg, int* post, uint8_t* conv, int* gbad, int C, int V, int Dc,
                  int Dv, int S, int it0, int n_it, int max_iter, int alpha_num, int early_stop,
                  int shot_block, int G, cudaStream_t stream) {
  const dim3 threads(LANES, WORKERS);
  const int blocks = (S + LANES - 1) / LANES;
  bsr_bp_int8_kernel<MAXP><<<blocks, threads, 0, stream>>>(
      chk_vars, vm, synd, prior_q, msg, post, conv, gbad, C, V, Dc, Dv, S, it0, n_it, max_iter,
      alpha_num, early_stop, shot_block, G);
  return (int)cudaGetLastError();
}

extern "C" int bsr_bp_int8(const void* chk_vars, const void* vm, const void* synd,
                           const void* prior_q, void* msg, void* post, void* conv, void* gbad,
                           int C, int V, int Dc, int Dv, int S, int it0, int n_it, int max_iter,
                           int alpha_num, int early_stop, int shot_block, int G, void* stream) {
  auto args = [&](auto f) {
    return f((const int*)chk_vars, (const int*)vm, (const uint8_t*)synd, (const int*)prior_q,
             (int8_t*)msg, (int*)post, (uint8_t*)conv, (int*)gbad, C, V, Dc, Dv, S, it0, n_it,
             max_iter, alpha_num, early_stop, shot_block, G, (cudaStream_t)stream);
  };
  if (Dc <= 8) return args([](auto... a) { return launch<8>(a...); });
  if (Dc <= 16) return args([](auto... a) { return launch<16>(a...); });
  if (Dc <= 32) return args([](auto... a) { return launch<32>(a...); });
  return (int)cudaErrorInvalidValue;
}
