// K3: one flooding iteration of spacetime BP with bf16 messages.
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
//   * alpha arrives per launch; the loop and the global early exit live in
//     the caller;
//   * conv[s] is the exact spacetime syndrome check of the estimate of the
//     iteration just completed.
//
// What bounds it on an H100: every launch streams the whole message state
// of every shot through device memory (for 4-round HGP-225: 3.8k bf16 data
// messages read and written twice, plus the f32 posteriors, ~40 KB per shot
// per iteration), and each message update is a short dependent chain of
// loads, so it is bound by memory latency and bandwidth, not arithmetic.
// The design exposes as many independent loads as it can: a block owns 32
// shots (one per lane, so every access of a warp is 32 consecutive shots of
// one row: coalesced), and its W warps split the work of those shots —
// the checks of all round blocks in phase A, the measurement and data
// variables in phase B, the parity checks in phase C — with a block barrier
// between phases.  Nothing crosses blocks, so the TPU's "finalize block b's
// parity one grid step late" needs no counterpart: phase C sees the whole
// iteration.  The two f32 check->measurement messages live in a scratch
// array between phases A and B.  The Tanner tables (identical for all
// threads) are read through the read-only cache; the TPU's 128x128 one-hot
// tiles have no counterpart.  Each check, variable and parity is computed
// by one thread in the plain version's order, so results are bit-identical.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "spacetime_bp.cuh"

__device__ __forceinline__ float bf(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

template <int MAXP>
__global__ void __launch_bounds__(LANES* WORKERS) stbsr_iter_kernel(
    const int* __restrict__ chk_vars,   // (r*Dc,), -1 = padded slot
    const int* __restrict__ vm,         // (n*Dv,), flat check-major slot, -1 = pad
    __nv_bfloat16* __restrict__ msg,    // (B*r*Dc, S) v2c in, v2c out
    __nv_bfloat16* __restrict__ mlo,    // (R*r, S) m_b <-> check block b
    __nv_bfloat16* __restrict__ mhi,    // (R*r, S) m_b <-> check block b+1
    const uint8_t* __restrict__ synd,   // (B*r, S)
    const float* __restrict__ prior_d,  // (B*n,)
    const float* __restrict__ mprior,   // (R*r,)
    float* __restrict__ post_d,         // (B*n, S) out
    float* __restrict__ post_m,         // (R*r, S) out
    uint8_t* __restrict__ conv,         // (S,) out
    float* __restrict__ c2m,            // (2*R*r, S) scratch: c2m_lo then c2m_hi
    int r, int n, int Dc, int Dv, int R, int S, int method, float alpha) {
  __shared__ int bad[LANES];
  const int lane = threadIdx.x;
  const int w = threadIdx.y;
  const int s = blockIdx.x * LANES + lane;
  const bool active = s < S;
  const int B = R + 1;
  const int P = Dc + 2;
  const size_t SS = (size_t)S;
  float* c2m_lo = c2m;                        // check block b -> m_b
  float* c2m_hi = c2m + (size_t)R * r * SS;   // check block b+1 -> m_b
  if (w == 0) bad[lane] = 0;

  // ---- phase A: check update of every check of every round block
  if (active) {
    for (int q = w; q < B * r; q += WORKERS) {
      const int b = q / r, c = q - b * r;
      float x[MAXP];
      const size_t e0 = (size_t)q * Dc;
#pragma unroll
      for (int i = 0; i < MAXP; ++i)
        if (i < Dc) x[i] = __bfloat162float(msg[(e0 + i) * SS + s]);
      const size_t m_prev = (size_t)(q - r) * SS + s;  // m_{b-1}
      const size_t m_next = (size_t)q * SS + s;        // m_b
      const float vhi = (b > 0) ? __bfloat162float(mhi[m_prev]) : BIG;
      const float vlo = (b < R) ? __bfloat162float(mlo[m_next]) : BIG;
#pragma unroll
      for (int i = 0; i < MAXP; ++i) {
        if (i == Dc) x[i] = vhi;
        if (i == Dc + 1) x[i] = vlo;
      }
      const float ss = synd[(size_t)q * SS + s] ? -1.0f : 1.0f;
      check_update<MAXP>(x, P, ss, method, alpha);
#pragma unroll
      for (int i = 0; i < MAXP; ++i) {
        if (i < Dc && __ldg(&chk_vars[c * Dc + i]) >= 0)
          msg[(e0 + i) * SS + s] = __float2bfloat16_rn(x[i]);
        if (i == Dc && b > 0) c2m_hi[m_prev] = x[i];
        if (i == Dc + 1 && b < R) c2m_lo[m_next] = x[i];
      }
    }
  }
  __syncthreads();

  // ---- phase B: measurement variables (closed form), then data variables
  if (active) {
    const int nm = R * r;
    for (int u = w; u < nm + B * n; u += WORKERS) {
      if (u < nm) {
        const size_t idx = (size_t)u * SS + s;
        const float lo = c2m_lo[idx], hi = c2m_hi[idx];
        const float pm = (mprior[u] + lo) + hi;
        mlo[idx] = __float2bfloat16_rn(pm - lo);
        mhi[idx] = __float2bfloat16_rn(pm - hi);
        post_m[idx] = pm;
        continue;
      }
      const int bv = u - nm, b = bv / n, v = bv - b * n;
      const size_t eb = (size_t)b * r * Dc;
      float total = prior_d[bv];
      for (int j = 0; j < Dv; ++j) {
        int k = __ldg(&vm[v * Dv + j]);
        if (k >= 0) total += __bfloat162float(msg[(eb + k) * SS + s]);
      }
      post_d[(size_t)bv * SS + s] = total;
      const float pb = bf(total);
      for (int j = 0; j < Dv; ++j) {
        int k = __ldg(&vm[v * Dv + j]);
        if (k >= 0) {
          const size_t idx = (eb + k) * SS + s;
          msg[idx] = __float2bfloat16_rn(pb - __bfloat162float(msg[idx]));
        }
      }
    }
  }
  __syncthreads();

  // ---- phase C: exact spacetime syndrome check of this iteration's estimate
  if (active) {
    int any = 0;
    for (int q = w; q < B * r; q += WORKERS) {
      const int b = q / r, c = q - b * r;
      int par = synd[(size_t)q * SS + s];
      for (int i = 0; i < Dc; ++i) {
        int v = __ldg(&chk_vars[c * Dc + i]);
        if (v >= 0) par ^= (bf(post_d[(size_t)(b * n + v) * SS + s]) <= 0.0f);
      }
      if (b > 0) par ^= (post_m[(size_t)(q - r) * SS + s] <= 0.0f);
      if (b < R) par ^= (post_m[(size_t)q * SS + s] <= 0.0f);
      any |= par;
    }
    if (any) atomicOr(&bad[lane], 1);
  }
  __syncthreads();
  if (active && w == 0) conv[s] = bad[lane] ? 0 : 1;
}

template <int MAXP>
static int launch(const int* chk_vars, const int* vm, __nv_bfloat16* msg, __nv_bfloat16* mlo,
                  __nv_bfloat16* mhi, const uint8_t* synd, const float* prior_d,
                  const float* mprior, float* post_d, float* post_m, uint8_t* conv, float* c2m,
                  int r, int n, int Dc, int Dv, int R, int S, int method, float alpha,
                  cudaStream_t stream) {
  const dim3 threads(LANES, WORKERS);
  const int blocks = (S + LANES - 1) / LANES;
  stbsr_iter_kernel<MAXP><<<blocks, threads, 0, stream>>>(
      chk_vars, vm, msg, mlo, mhi, synd, prior_d, mprior, post_d, post_m, conv, c2m, r, n, Dc,
      Dv, R, S, method, alpha);
  return (int)cudaGetLastError();
}

extern "C" int stbsr_iter(const void* chk_vars, const void* vm, void* msg, void* mlo, void* mhi,
                          const void* synd, const void* prior_d, const void* mprior, void* post_d,
                          void* post_m, void* conv, void* c2m, int r, int n, int Dc, int Dv,
                          int R, int S, int method, float alpha, void* stream) {
  const int P = Dc + 2;
  auto args = [&](auto f) {
    return f((const int*)chk_vars, (const int*)vm, (__nv_bfloat16*)msg, (__nv_bfloat16*)mlo,
             (__nv_bfloat16*)mhi, (const uint8_t*)synd, (const float*)prior_d,
             (const float*)mprior, (float*)post_d, (float*)post_m, (uint8_t*)conv, (float*)c2m,
             r, n, Dc, Dv, R, S, method, alpha, (cudaStream_t)stream);
  };
  if (P <= 8) return args([](auto... a) { return launch<8>(a...); });
  if (P <= 16) return args([](auto... a) { return launch<16>(a...); });
  if (P <= 32) return args([](auto... a) { return launch<32>(a...); });
  return (int)cudaErrorInvalidValue;
}
