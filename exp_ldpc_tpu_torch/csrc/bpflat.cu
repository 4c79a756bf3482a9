// K6: fixed-iteration flat flooding BP, f32, all iterations in one launch.
//
// Replaces exp_ldpc_tpu/decoders/bp_pallas.py::_kernel (the VMEM-resident
// Pallas kernel launched by bp_pallas_fixed).  Same contract as
// bp_core(..., early_stop=False) in decoders/bp.py, which is this kernel's
// plain version:
//   * v2c messages in the TannerELL check-major layout (C*Dc rows), padded
//     slots held at +1e30;
//   * check update "ps" (sign/phi) or "ms" (min-sum, fixed alpha, or the
//     adaptive 1 - 2^-(t+1) when alpha0 == 0), over all Dc slots;
//   * variable update through the variable->edge table: the variable's
//     messages summed in edge order, then the prior added;
//   * a final syndrome check per shot.
//
// What bounds it on an H100: every iteration streams each message of each
// shot through device memory twice (check pass, variable pass), and each
// update is a short dependent chain of loads, so it is bound by memory
// latency, not arithmetic.  The TPU kernel keeps the state in VMEM and
// routes it with dense one-hot matmuls; here the state cannot stay on chip
// at 16k shots, so the design is K2's (csrc/stbp.cu): a block owns 32 shots
// (one per lane, so every warp access is 32 consecutive shots of one row:
// coalesced) and its 8 warps split each phase — all checks (A), then all
// variables (B) — with a block barrier between phases.  Blocks never meet,
// so all iterations run in one launch.  The one-hot matmuls become gathers
// through the Tanner tables (read through the read-only cache); messages
// are updated in place.  Each check and variable is computed by one thread
// in the plain version's order, so results are bit-identical to it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "spacetime_bp.cuh"

template <int MAXP>
__global__ void __launch_bounds__(LANES* WORKERS) bp_fixed_kernel(
    const uint8_t* __restrict__ synd,     // (C, S) 0/1
    const float* __restrict__ prior,      // (V,) LLRs
    const int* __restrict__ chk_vars,     // (C*Dc,), -1 = padded slot
    const int* __restrict__ vm,           // (V*Dv,), flat check-major slot, -1 = pad
    float* __restrict__ msg,              // (C*Dc, S) scratch
    float* __restrict__ post,             // (V, S) out
    uint8_t* __restrict__ conv,           // (S,) out
    int C, int V, int Dc, int Dv, int S, int max_iter, int method, float alpha0) {
  __shared__ int bad[LANES];
  const int lane = threadIdx.x;
  const int w = threadIdx.y;
  const int s = blockIdx.x * LANES + lane;
  const bool active = s < S;
  const size_t SS = (size_t)S;
  if (w == 0) bad[lane] = 0;

  // init: v2c = priors; posterior = priors (the answer for max_iter == 0)
  if (active) {
    for (int e = w; e < C * Dc; e += WORKERS) {
      const int v = __ldg(&chk_vars[e]);
      msg[(size_t)e * SS + s] = (v >= 0) ? __ldg(&prior[v]) : BIG;
    }
    for (int v = w; v < V; v += WORKERS) post[(size_t)v * SS + s] = __ldg(&prior[v]);
  }
  __syncthreads();

  for (int it = 0; it < max_iter; ++it) {
    const float alpha = (alpha0 == 0.0f) ? 1.0f - ldexpf(1.0f, -(it + 1)) : alpha0;
    const bool last = (it == max_iter - 1);
    // ---- phase A: check update of every check, in place (padded slots stay +BIG)
    if (active) {
      for (int c = w; c < C; c += WORKERS) {
        float x[MAXP];
        const size_t e0 = (size_t)c * Dc;
#pragma unroll
        for (int i = 0; i < MAXP; ++i)
          if (i < Dc) x[i] = msg[(e0 + i) * SS + s];
        const float ss = synd[(size_t)c * SS + s] ? -1.0f : 1.0f;
        check_update<MAXP>(x, Dc, ss, method, alpha);
#pragma unroll
        for (int i = 0; i < MAXP; ++i)
          if (i < Dc && __ldg(&chk_vars[e0 + i]) >= 0) msg[(e0 + i) * SS + s] = x[i];
      }
    }
    __syncthreads();
    // ---- phase B: variable update: edges summed in order, then the prior
    if (active) {
      for (int v = w; v < V; v += WORKERS) {
        float total = 0.0f;
        for (int j = 0; j < Dv; ++j) {
          const int k = __ldg(&vm[v * Dv + j]);
          if (k >= 0) total += msg[(size_t)k * SS + s];
        }
        const float pv = __ldg(&prior[v]) + total;
        if (last) post[(size_t)v * SS + s] = pv;
        for (int j = 0; j < Dv; ++j) {
          const int k = __ldg(&vm[v * Dv + j]);
          if (k >= 0) {
            const size_t idx = (size_t)k * SS + s;
            msg[idx] = pv - msg[idx];
          }
        }
      }
    }
    __syncthreads();
  }

  // ---- syndrome check of the final estimate
  if (active) {
    int any = 0;
    for (int c = w; c < C; c += WORKERS) {
      int par = synd[(size_t)c * SS + s];
      for (int i = 0; i < Dc; ++i) {
        const int v = __ldg(&chk_vars[c * Dc + i]);
        if (v >= 0) par ^= (post[(size_t)v * SS + s] <= 0.0f);
      }
      any |= par;
    }
    if (any) atomicOr(&bad[lane], 1);
  }
  __syncthreads();
  if (active && w == 0) conv[s] = bad[lane] ? 0 : 1;
}

template <int MAXP>
static int launch(const uint8_t* synd, const float* prior, const int* chk_vars, const int* vm,
                  float* msg, float* post, uint8_t* conv, int C, int V, int Dc, int Dv, int S,
                  int max_iter, int method, float alpha0, cudaStream_t stream) {
  const dim3 threads(LANES, WORKERS);
  const int blocks = (S + LANES - 1) / LANES;
  bp_fixed_kernel<MAXP><<<blocks, threads, 0, stream>>>(
      synd, prior, chk_vars, vm, msg, post, conv, C, V, Dc, Dv, S, max_iter, method, alpha0);
  return (int)cudaGetLastError();
}

extern "C" int bp_fixed(const void* synd, const void* prior, const void* chk_vars, const void* vm,
                        void* msg, void* post, void* conv, int C, int V, int Dc, int Dv, int S,
                        int max_iter, int method, float alpha0, void* stream) {
  auto args = [&](auto f) {
    return f((const uint8_t*)synd, (const float*)prior, (const int*)chk_vars, (const int*)vm,
             (float*)msg, (float*)post, (uint8_t*)conv, C, V, Dc, Dv, S, max_iter, method,
             alpha0, (cudaStream_t)stream);
  };
  if (Dc <= 8) return args([](auto... a) { return launch<8>(a...); });
  if (Dc <= 16) return args([](auto... a) { return launch<16>(a...); });
  if (Dc <= 32) return args([](auto... a) { return launch<32>(a...); });
  return (int)cudaErrorInvalidValue;
}
