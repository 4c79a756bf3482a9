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
// Each check and variable is computed by one thread in the plain version's
// order, so results are bit-identical to it.  Tensor cores have no role: the
// function holds no matrix product of its own (the TPU kernel's one-hot
// products are routing, done here by gathers through the Tanner tables).
//
// What bounds it on an H100.  A shot's state is C*Dc f32 messages and C
// syndrome bytes: 3,564 B at HGP-225's (H|I), 57 MB at 16,384 shots, just
// past the 50 MB L2; streamed through device memory (four passes per
// message per iteration) the kernel is bound by memory latency and
// bandwidth.  Two routes, chosen in Python from the shape before the launch
// (utils/cuda_build.py::resident_plan), as in K2 (csrc/stbp.cu):
//
// * resident (bp_resident_kernel): a block owns G shots (~62 at (H|I)) and
//   keeps all their messages and syndromes in dynamic shared memory for every
//   iteration, the TPU kernel's VMEM residency; device memory sees the
//   syndromes and priors once and the posteriors and conv once.  The
//   block's threads walk (check, shot) items, then (variable, shot) items,
//   shots innermost, with a block barrier between.  Messages are
//   slot-major (row i*C + c for slot i of check c), so a warp's check items
//   read consecutive words.  The tables sit in shared memory where they fit
//   beside a shot, else they are read through the read-only cache.
// * streamed (bp_streamed_kernel, the first port of this kernel) where one shot's state
//   exceeds the opt-in limit (the n = 40,000 HGP: 538 KB a shot): a block
//   owns 32 shots (one per lane, so every warp access is 32 consecutive
//   shots of one row: coalesced) and its 8 warps split each phase; the
//   messages live in device memory, updated in place; the tables are read
//   through the read-only cache.
//
// Checks of more than MAX_SLOTS (32) slots take route "wide" on either
// route: the check phase in two passes over the slots (WideCheck,
// spacetime_bp.cuh), whose registers do not grow with Dc, and the live slots
// read from the tables' -1 sentinel instead of a 32-bit mask.  The caller's
// plan names the route and the entry point refuses one that does not match
// the degree.
#include <cuda_runtime.h>
#include <stdint.h>

#include "resident_bp.cuh"
#include "spacetime_bp.cuh"

// ---------------------------------------------------------------------------
// The streamed route
// ---------------------------------------------------------------------------

template <int MAXP, bool WIDE>
__global__ void __launch_bounds__(LANES* WORKERS) bp_streamed_kernel(
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
        const size_t e0 = (size_t)c * Dc;
        if constexpr (WIDE) {
          WideCheck wk;
          wk.init(synd[(size_t)c * SS + s] ? -1.0f : 1.0f);
          for (int i = 0; i < Dc; ++i) wk.fold(i, msg[(e0 + i) * SS + s], method);
          for (int i = 0; i < Dc; ++i) {
            if (__ldg(&chk_vars[e0 + i]) < 0) continue;
            const size_t k = (e0 + i) * SS + s;
            msg[k] = wk.out(i, msg[k], method, alpha);
          }
          continue;
        }
        float x[MAXP];
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

// ---------------------------------------------------------------------------
// The resident route
// ---------------------------------------------------------------------------

// Dynamic shared memory of a resident block, in this order (4-byte words,
// then bytes), each per-shot array [row][stride]:
//   msg  Dc*C rows (slot-major: row i*C + c)         f32
//   bad  stride                                       i32 (per-shot flag)
//   live C                                            i32 (bit i: slot i is an edge)
//   [chk_vars C*Dc, vm V*Dv]  when tables_smem        i32 (vm as slot-major rows)
//   sy   C rows                                       u8
// decoders/bp_cuda.py::resident_bytes computes the same sizes.
static size_t bp_resident_bytes(int C, int V, int Dc, int Dv, int stride, int tables_smem) {
  const size_t words = ((size_t)Dc * C + 1) * stride + C +
                       (tables_smem ? (size_t)C * Dc + (size_t)V * Dv : 0);
  return 4 * words + (size_t)C * stride;
}

template <int MAXP, bool EXACT, bool WIDE>
__global__ void __launch_bounds__(ResidentThreads<MAXP>::value) bp_resident_kernel(
    const uint8_t* __restrict__ synd,     // (C, S) 0/1
    const float* __restrict__ prior,      // (V,) LLRs
    const int* __restrict__ chk_vars_g,   // (C*Dc,), -1 = padded slot
    const int* __restrict__ vm_g,         // (V*Dv,), flat check-major slot, -1 = pad
    float* __restrict__ post,             // (V, S) out
    uint8_t* __restrict__ conv,           // (S,) out
    int C, int V, int Dc_rt, int Dv, int S, int max_iter, int method, float alpha0, int G,
    int stride, int tables_smem) {
  extern __shared__ float4 smem4[];
  const int Dc = EXACT ? MAXP : Dc_rt;   // exact-width instances fix the check width
  const int s0 = blockIdx.x * G;
  const int Gb = min(G, S - s0);         // the last block may hold fewer shots
  const size_t SS = (size_t)S;
  const int T = blockDim.x, tid = threadIdx.x;

  float* msg = reinterpret_cast<float*>(smem4);
  int* bad = reinterpret_cast<int*>(msg + Dc * C * stride);
  int* live = bad + stride;
  int* chk_vars = live + C;
  int* vm = chk_vars + (tables_smem ? C * Dc : 0);
  uint8_t* sy = reinterpret_cast<uint8_t*>(vm + (tables_smem ? V * Dv : 0));

  // an edge of the variable->edge table as a slot-major row
  auto remap = [&](int k) { return k < 0 ? -1 : (k % Dc) * C + k / Dc; };
  for (int c = tid; c < C && !WIDE; c += T) {  // route "wide" reads the tables' sentinel
    int m = 0;
    for (int i = 0; i < Dc; ++i)
      if (__ldg(&chk_vars_g[c * Dc + i]) >= 0) m |= 1 << i;
    live[c] = m;
  }
  if (tables_smem) {
    for (int i = tid; i < C * Dc; i += T) chk_vars[i] = __ldg(&chk_vars_g[i]);
    for (int i = tid; i < V * Dv; i += T) vm[i] = remap(__ldg(&vm_g[i]));
  }
  for (int g = tid; g < stride; g += T) bad[g] = 0;
  __syncthreads();  // the tables, before any thread reads them
  auto cvar = [&](int i) { return tables_smem ? chk_vars[i] : __ldg(&chk_vars_g[i]); };
  auto vmk = [&](int i) { return tables_smem ? vm[i] : remap(__ldg(&vm_g[i])); };

  // init: v2c = priors, syndromes in; posterior = priors if max_iter == 0
  walk(1, C, Gb, [&](int, int c, int g) {
    for (int i = 0; i < Dc; ++i) {
      const int v = cvar(c * Dc + i);
      msg[(i * C + c) * stride + g] = (v >= 0) ? __ldg(&prior[v]) : BIG;
    }
    sy[c * stride + g] = synd[(size_t)c * SS + s0 + g];
  });
  if (max_iter == 0)
    walk(1, V, Gb, [&](int, int v, int g) { post[(size_t)v * SS + s0 + g] = __ldg(&prior[v]); });
  __syncthreads();

  for (int it = 0; it < max_iter; ++it) {
    const float alpha = (alpha0 == 0.0f) ? 1.0f - ldexpf(1.0f, -(it + 1)) : alpha0;
    const bool last = (it == max_iter - 1);
    // ---- checks, in place (padded slots stay +BIG)
    walk(1, C, Gb, [&](int, int c, int g) {
      const float ss = sy[c * stride + g] ? -1.0f : 1.0f;
      if constexpr (WIDE) {
        WideCheck wk;
        wk.init(ss);
        for (int i = 0; i < Dc; ++i) wk.fold(i, msg[(i * C + c) * stride + g], method);
        for (int i = 0; i < Dc; ++i) {
          if (cvar(c * Dc + i) < 0) continue;
          const int k = (i * C + c) * stride + g;
          msg[k] = wk.out(i, msg[k], method, alpha);
        }
        return;
      }
      float x[MAXP];
#pragma unroll
      for (int i = 0; i < MAXP; ++i)
        if (i < Dc) x[i] = msg[(i * C + c) * stride + g];
      check_update<MAXP>(x, Dc, ss, method, alpha);
      const int lv = live[c];
#pragma unroll
      for (int i = 0; i < MAXP; ++i)
        if (i < Dc && ((lv >> i) & 1)) msg[(i * C + c) * stride + g] = x[i];
    });
    __syncthreads();
    // ---- variables: edges summed in order, then the prior; the last
    // iteration writes the posteriors and leaves the messages
    walk(1, V, Gb, [&](int, int v, int g) {
      float gv[8];
      int kk[8];
      float total = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < Dv) {
          kk[j] = vmk(v * Dv + j);
          if (kk[j] >= 0) {
            gv[j] = msg[kk[j] * stride + g];
            total += gv[j];
          }
        }
      }
      for (int j = 8; j < Dv; ++j) {
        const int k = vmk(v * Dv + j);
        if (k >= 0) total += msg[k * stride + g];
      }
      const float pv = __ldg(&prior[v]) + total;
      if (last) {
        post[(size_t)v * SS + s0 + g] = pv;
        return;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j < Dv && kk[j] >= 0) msg[kk[j] * stride + g] = pv - gv[j];
      for (int j = 8; j < Dv; ++j) {
        const int k = vmk(v * Dv + j);
        if (k >= 0) msg[k * stride + g] = pv - msg[k * stride + g];
      }
    });
    __syncthreads();
  }

  // ---- syndrome check of the final estimate (the block's own posterior
  // writes, visible after the barrier)
  walk(1, C, Gb, [&](int, int c, int g) {
    const size_t s = (size_t)s0 + g;
    int par = sy[c * stride + g];
    for (int i = 0; i < Dc; ++i) {
      const int v = cvar(c * Dc + i);
      if (v >= 0) par ^= (post[(size_t)v * SS + s] <= 0.0f);
    }
    if (par) bad[g] = 1;
  });
  __syncthreads();
  for (int g = tid; g < Gb; g += T) conv[s0 + g] = bad[g] ? 0 : 1;
}

// ---------------------------------------------------------------------------
// Entry point
// ---------------------------------------------------------------------------

template <int MAXP, bool WIDE = false>
static int streamed(const uint8_t* synd, const float* prior, const int* chk_vars, const int* vm,
                    float* msg, float* post, uint8_t* conv, int C, int V, int Dc, int Dv, int S,
                    int max_iter, int method, float alpha0, cudaStream_t stream) {
  const dim3 threads(LANES, WORKERS);
  const int blocks = (S + LANES - 1) / LANES;
  bp_streamed_kernel<MAXP, WIDE><<<blocks, threads, 0, stream>>>(
      synd, prior, chk_vars, vm, msg, post, conv, C, V, Dc, Dv, S, max_iter, method, alpha0);
  return (int)cudaGetLastError();
}

template <int MAXP, bool EXACT, bool WIDE = false>
static int resident(const uint8_t* synd, const float* prior, const int* chk_vars, const int* vm,
                    float* post, uint8_t* conv, int C, int V, int Dc, int Dv, int S,
                    int max_iter, int method, float alpha0, int G, int stride, int threads,
                    int tables_smem, int smem_bytes, cudaStream_t stream) {
  if (threads > ResidentThreads<MAXP>::value || G < 1 || stride < G ||
      (size_t)smem_bytes != bp_resident_bytes(C, V, Dc, Dv, stride, tables_smem))
    return (int)cudaErrorInvalidValue;
  return launch_resident(bp_resident_kernel<MAXP, EXACT, WIDE>, (S + G - 1) / G, threads, smem_bytes,
                         stream, synd, prior, chk_vars, vm, post, conv, C, V, Dc, Dv, S,
                         max_iter, method, alpha0, G, stride, tables_smem);
}

// group > 0: the resident route (group shots per block, rows of `stride`
// slots, `threads` per block, `smem_bytes` of dynamic shared memory, which
// must equal the layout's); group == 0: the streamed route (msg is its
// device-memory scratch; it takes no dynamic shared memory).  `wide`: route
// "wide" on either route, exactly where Dc exceeds MAX_SLOTS.
extern "C" int bp_fixed(const void* synd, const void* prior, const void* chk_vars, const void* vm,
                        void* msg, void* post, void* conv, int C, int V, int Dc, int Dv, int S,
                        int max_iter, int method, float alpha0, int group, int stride,
                        int threads, int tables_smem, int smem_bytes, int wide, void* stream) {
  if ((wide != 0) != (Dc > MAX_SLOTS)) return (int)cudaErrorInvalidValue;
  const uint8_t* sy = (const uint8_t*)synd;
  const float* pr = (const float*)prior;
  const int* cv = (const int*)chk_vars;
  const int* vt = (const int*)vm;
  cudaStream_t st = (cudaStream_t)stream;
  if (group > 0) {
    auto go = [&](auto f) {
      return f(sy, pr, cv, vt, (float*)post, (uint8_t*)conv, C, V, Dc, Dv, S, max_iter, method,
               alpha0, group, stride, threads, tables_smem, smem_bytes, st);
    };
    if (wide) return go([](auto... a) { return resident<32, false, true>(a...); });
    // exact widths: HGP's H (7) and (H|I) (8)
    if (Dc == 7) return go([](auto... a) { return resident<7, true>(a...); });
    if (Dc == 8) return go([](auto... a) { return resident<8, true>(a...); });
    if (Dc < 8) return go([](auto... a) { return resident<8, false>(a...); });
    if (Dc <= 16) return go([](auto... a) { return resident<16, false>(a...); });
    if (Dc <= 32) return go([](auto... a) { return resident<32, false>(a...); });
    return (int)cudaErrorInvalidValue;
  }
  auto go = [&](auto f) {
    return f(sy, pr, cv, vt, (float*)msg, (float*)post, (uint8_t*)conv, C, V, Dc, Dv, S,
             max_iter, method, alpha0, st);
  };
  if (wide) return go([](auto... a) { return streamed<32, true>(a...); });
  if (Dc <= 8) return go([](auto... a) { return streamed<8>(a...); });
  if (Dc <= 16) return go([](auto... a) { return streamed<16>(a...); });
  if (Dc <= 32) return go([](auto... a) { return streamed<32>(a...); });
  return (int)cudaErrorInvalidValue;
}
