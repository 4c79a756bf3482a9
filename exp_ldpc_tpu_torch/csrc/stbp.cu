// K2: fixed-iteration structured spacetime BP, f32, all iterations in one launch.
//
// Replaces exp_ldpc_tpu/decoders/spacetime_bp_pallas.py::_kernel (the
// VMEM-resident Pallas kernel launched by stbp_pallas_fixed).  Same contract
// as stbp_core(..., early_stop=False) in decoders/spacetime_bp.py, which is
// this kernel's plain version:
//   * (rounds+1) copies of the base H; each check carries Dc data slots plus
//     two measurement slots (previous / next round), boundary slots held at
//     +1e30;
//   * check update "ps" (sign/phi) or "ms" (min-sum, fixed alpha, or the
//     adaptive 1 - 2^-(t+1) when alpha0 == 0);
//   * data-variable update through the base code's variable->edge table,
//     summed in edge order; measurement variables in closed form;
//   * a final spacetime syndrome check per shot.
//
// What bounds it on an H100: each iteration streams every message of every
// shot through device memory twice (check pass, variable pass): for 4-round
// HGP-225 ~4.6k f32 messages, ~37 KB read + written per shot per iteration,
// and each update is a short dependent chain of loads, so the kernel is
// bound by memory latency and bandwidth, not arithmetic.  The TPU keeps the
// state in VMEM; here it cannot stay on chip (16k shots x 18 KB), so the
// design hides latency with parallelism instead: a block owns 32 shots (one
// per lane: every warp access is 32 consecutive shots of one row,
// coalesced), and its W warps split each phase of an iteration — all
// checks (A), then all measurement and data variables (B) — with a block
// barrier between phases; the blocks never need to meet, so all iterations
// run in one launch.  The Tanner index tables sit in shared memory (a warp
// reads one entry: a broadcast).  The TPU's one-hot matmuls become gathers
// through the tables.  Messages are updated in place: a check overwrites its
// incoming v2c with its outgoing c2v, the variable pass overwrites c2v with
// the next v2c.  Each check and variable is computed by one thread in the
// plain version's order, so results are bit-identical to it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "spacetime_bp.cuh"

template <int MAXP>
__global__ void __launch_bounds__(LANES* WORKERS) stbp_fixed_kernel(
    const uint8_t* __restrict__ synd,     // (B*r, S) 0/1
    const float* __restrict__ prior,      // (B*n + R*r,) LLRs
    const int* __restrict__ chk_vars_g,   // (r*Dc,), -1 = padded slot
    const int* __restrict__ vm_g,         // (n*Dv,), flat check-major slot, -1 = pad
    float* __restrict__ msg,              // (B*r*Dc, S) scratch
    float* __restrict__ mlo,              // (R*r, S) scratch: m_b <-> check block b
    float* __restrict__ mhi,              // (R*r, S) scratch: m_b <-> check block b+1
    float* __restrict__ post,             // (B*n + R*r, S) out
    uint8_t* __restrict__ conv,           // (S,) out
    int r, int n, int Dc, int Dv, int R, int S, int max_iter, int method, float alpha0) {
  extern __shared__ int smem[];
  __shared__ int bad[LANES];
  int* chk_vars = smem;          // r*Dc
  int* vm = smem + r * Dc;       // n*Dv
  const int lane = threadIdx.x;
  const int w = threadIdx.y;
  const int tid = w * LANES + lane;
  for (int i = tid; i < r * Dc; i += LANES * WORKERS) chk_vars[i] = chk_vars_g[i];
  for (int i = tid; i < n * Dv; i += LANES * WORKERS) vm[i] = vm_g[i];
  if (w == 0) bad[lane] = 0;
  __syncthreads();

  const int s = blockIdx.x * LANES + lane;
  const bool active = s < S;
  const int B = R + 1;
  const int P = Dc + 2;
  const int nm = R * r;
  const size_t SS = (size_t)S;
  const float* mprior = prior + (size_t)B * n;

  // init: v2c = priors; posterior = priors (the answer for max_iter == 0)
  if (active) {
    for (int q = w; q < B * r; q += WORKERS) {
      const int b = q / r, c = q - b * r;
      for (int i = 0; i < Dc; ++i) {
        int v = chk_vars[c * Dc + i];
        msg[((size_t)q * Dc + i) * SS + s] = (v >= 0) ? prior[b * n + v] : BIG;
      }
    }
    for (int u = w; u < B * n + nm; u += WORKERS) post[(size_t)u * SS + s] = prior[u];
    for (int m = w; m < nm; m += WORKERS) {
      mlo[(size_t)m * SS + s] = mprior[m];
      mhi[(size_t)m * SS + s] = mprior[m];
    }
  }
  __syncthreads();

  for (int it = 0; it < max_iter; ++it) {
    const float alpha = (alpha0 == 0.0f) ? 1.0f - ldexpf(1.0f, -(it + 1)) : alpha0;
    const bool last = (it == max_iter - 1);
    // ---- phase A: check update of every check of every round block; the
    // two measurement c2v messages go in place into mhi / mlo
    if (active) {
      for (int q = w; q < B * r; q += WORKERS) {
        const int b = q / r, c = q - b * r;
        float x[MAXP];
        const size_t e0 = (size_t)q * Dc;
#pragma unroll
        for (int i = 0; i < MAXP; ++i)
          if (i < Dc) x[i] = msg[(e0 + i) * SS + s];
        const size_t m_prev = (size_t)(q - r) * SS + s;  // m_{b-1}
        const size_t m_next = (size_t)q * SS + s;        // m_b
        const float vhi = (b > 0) ? mhi[m_prev] : BIG;
        const float vlo = (b < R) ? mlo[m_next] : BIG;
#pragma unroll
        for (int i = 0; i < MAXP; ++i) {
          if (i == Dc) x[i] = vhi;
          if (i == Dc + 1) x[i] = vlo;
        }
        const float ss = synd[(size_t)q * SS + s] ? -1.0f : 1.0f;
        check_update<MAXP>(x, P, ss, method, alpha);
#pragma unroll
        for (int i = 0; i < MAXP; ++i) {
          if (i < Dc && chk_vars[c * Dc + i] >= 0) msg[(e0 + i) * SS + s] = x[i];
          if (i == Dc && b > 0) mhi[m_prev] = x[i];
          if (i == Dc + 1 && b < R) mlo[m_next] = x[i];
        }
      }
    }
    __syncthreads();
    // ---- phase B: measurement variables (closed form), then data variables
    if (active) {
      for (int u = w; u < nm + B * n; u += WORKERS) {
        if (u < nm) {
          const size_t idx = (size_t)u * SS + s;
          const float lo = mlo[idx], hi = mhi[idx];
          const float pm = (mprior[u] + lo) + hi;
          mlo[idx] = pm - lo;
          mhi[idx] = pm - hi;
          if (last) post[((size_t)B * n + u) * SS + s] = pm;
          continue;
        }
        const int bv = u - nm, b = bv / n, v = bv - b * n;
        const size_t eb = (size_t)b * r * Dc;
        float total = 0.0f;
        for (int j = 0; j < Dv; ++j) {
          int k = vm[v * Dv + j];
          if (k >= 0) total += msg[(eb + k) * SS + s];
        }
        const float pv = prior[bv] + total;
        if (last) post[(size_t)bv * SS + s] = pv;
        for (int j = 0; j < Dv; ++j) {
          int k = vm[v * Dv + j];
          if (k >= 0) {
            const size_t idx = (eb + k) * SS + s;
            msg[idx] = pv - msg[idx];
          }
        }
      }
    }
    __syncthreads();
  }

  // ---- spacetime syndrome check of the final estimate
  if (active) {
    int any = 0;
    for (int q = w; q < B * r; q += WORKERS) {
      const int b = q / r, c = q - b * r;
      int par = synd[(size_t)q * SS + s];
      for (int i = 0; i < Dc; ++i) {
        int v = chk_vars[c * Dc + i];
        if (v >= 0) par ^= (post[(size_t)(b * n + v) * SS + s] <= 0.0f);
      }
      if (b > 0) par ^= (post[((size_t)B * n + q - r) * SS + s] <= 0.0f);
      if (b < R) par ^= (post[((size_t)B * n + q) * SS + s] <= 0.0f);
      any |= par;
    }
    if (any) atomicOr(&bad[lane], 1);
  }
  __syncthreads();
  if (active && w == 0) conv[s] = bad[lane] ? 0 : 1;
}

template <int MAXP>
static int launch(const uint8_t* synd, const float* prior, const int* chk_vars, const int* vm,
                  float* msg, float* mlo, float* mhi, float* post, uint8_t* conv, int r, int n,
                  int Dc, int Dv, int R, int S, int max_iter, int method, float alpha0,
                  cudaStream_t stream) {
  const dim3 threads(LANES, WORKERS);
  const int blocks = (S + LANES - 1) / LANES;
  const size_t shmem = (size_t)(r * Dc + n * Dv) * sizeof(int);
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(stbp_fixed_kernel<MAXP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  stbp_fixed_kernel<MAXP><<<blocks, threads, shmem, stream>>>(
      synd, prior, chk_vars, vm, msg, mlo, mhi, post, conv, r, n, Dc, Dv, R, S, max_iter, method,
      alpha0);
  return (int)cudaGetLastError();
}

extern "C" int stbp_fixed(const void* synd, const void* prior, const void* chk_vars,
                          const void* vm, void* msg, void* mlo, void* mhi, void* post, void* conv,
                          int r, int n, int Dc, int Dv, int R, int S, int max_iter, int method,
                          float alpha0, void* stream) {
  const int P = Dc + 2;
  auto args = [&](auto f) {
    return f((const uint8_t*)synd, (const float*)prior, (const int*)chk_vars, (const int*)vm,
             (float*)msg, (float*)mlo, (float*)mhi, (float*)post, (uint8_t*)conv, r, n, Dc, Dv, R,
             S, max_iter, method, alpha0, (cudaStream_t)stream);
  };
  if (P <= 8) return args([](auto... a) { return launch<8>(a...); });
  if (P <= 16) return args([](auto... a) { return launch<16>(a...); });
  if (P <= 32) return args([](auto... a) { return launch<32>(a...); });
  return (int)cudaErrorInvalidValue;
}
