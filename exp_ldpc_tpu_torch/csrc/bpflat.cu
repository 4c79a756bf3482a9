// K6: fixed-iteration flat flooding BP, f32, a whole decode in one call.
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
// past the 50 MB L2; 538 KB a shot at the n = 40,000 HGP.  Two routes,
// chosen in Python from the shape before the launch
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
// * streamed (bp_streamed_*_kernel) where one shot's state exceeds the
//   opt-in limit (the n = 40,000 HGP, the 4-round detector model): the
//   messages live in device memory, (C*Dc, S) shot-minor, and every
//   iteration reads and writes each of them twice (grid A, grid B): bound by
//   device-memory bandwidth.  K1's and K3's frame at f32
//   (csrc/streamed_bp.cuh): each phase is one grid over a flat list of
//   (row, 4 shots or 1) items, sized from the item count and the SM count,
//   so a few hundred shots of a large code fill the card; grid A updates
//   every check in place (the first iteration reads the priors through the
//   tables instead of an initialised message array), grid B every variable
//   (the sum in edge order, then the prior; the posterior in the last
//   iteration), and one parity grid follows the last iteration.  The C
//   entry point enqueues the whole decode (2 grids an iteration + 1); the
//   host reads nothing back.  The tables come through the read-only cache.
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
#include "streamed_bp.cuh"

// ---------------------------------------------------------------------------
// The streamed route
// ---------------------------------------------------------------------------

struct FlatArgs {
  const uint8_t* synd;    // (C, S) 0/1
  const float* prior;     // (V,) LLRs
  const int* chk_vars;    // (C*Dc,), -1 = padded slot
  const int* vm;          // (V*Dv,), flat check-major slot, -1 = pad
  float* msg;             // (C*Dc, S) scratch: v2c in, v2c out (real slots only)
  float* post;            // (V, S) out
  uint8_t* conv;          // (S,) out
  int C, V, Dc, Dv, S;
};

// ---- grid A: every check, in place.  x[VEC][MAXP] lives in registers: 4
// shots a lane up to 16 slots; one above (two spilled, and ran 23% slower at
// the cyclic code's 24 slots on an H100).
template <int MAXP, int VEC, int METHOD>
__global__ void __launch_bounds__(ROW_THREADS, 2) bp_streamed_check_kernel(const FlatArgs a,
                                                                         float alpha,
                                                                         bool first) {
  const size_t SS = (size_t)a.S;
  const int Dc = a.Dc;
  RowItems items(a.C, a.S, VEC);
  int c, s0;
  while (items.next(c, s0, VEC)) {
    const size_t e0 = (size_t)c * Dc;
    float x[VEC][MAXP], t[VEC];
#pragma unroll
    for (int i = 0; i < MAXP; ++i) {
      if (i < Dc) {
        stream_slot<VEC>(__ldg(&a.chk_vars[e0 + i]), first, a.prior,
                         a.msg + (e0 + i) * SS + s0, t);
#pragma unroll
        for (int k = 0; k < VEC; ++k) x[k][i] = t[k];
      }
    }
    const Pack<VEC> sy = ld_raw_ro<VEC>(a.synd + (size_t)c * SS + s0);
#pragma unroll
    for (int k = 0; k < VEC; ++k) check_update<MAXP>(x[k], Dc, sy.u8[k] ? -1.0f : 1.0f, METHOD, alpha);
#pragma unroll
    for (int i = 0; i < MAXP; ++i) {
      if (i < Dc && __ldg(&a.chk_vars[e0 + i]) >= 0) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) t[k] = x[k][i];
        st_f32<VEC>(a.msg + (e0 + i) * SS + s0, t);
      }
    }
  }
}

// ---- grid A of route "wide" (more than MAX_SLOTS slots): two passes over
// the slots (WideCheck), whose registers do not grow with Dc; pass 2 reads
// each live slot again and stores its outgoing message in place.
template <int VEC, int METHOD>
__global__ void __launch_bounds__(ROW_THREADS) bp_streamed_check_wide_kernel(const FlatArgs a,
                                                                           float alpha,
                                                                           bool first) {
  const size_t SS = (size_t)a.S;
  const int Dc = a.Dc;
  RowItems items(a.C, a.S, VEC);
  int c, s0;
  while (items.next(c, s0, VEC)) {
    const size_t e0 = (size_t)c * Dc;
    float t[VEC];
    const Pack<VEC> sy = ld_raw_ro<VEC>(a.synd + (size_t)c * SS + s0);
    WideCheck w[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) w[k].init(sy.u8[k] ? -1.0f : 1.0f);
    for (int i = 0; i < Dc; ++i) {
      stream_slot<VEC>(__ldg(&a.chk_vars[e0 + i]), first, a.prior, a.msg + (e0 + i) * SS + s0, t);
#pragma unroll
      for (int k = 0; k < VEC; ++k) w[k].fold(i, t[k], METHOD);
    }
    for (int i = 0; i < Dc; ++i) {
      const int v = __ldg(&a.chk_vars[e0 + i]);
      if (v < 0) continue;
      float* p = a.msg + (e0 + i) * SS + s0;
      stream_slot<VEC>(v, first, a.prior, p, t);
#pragma unroll
      for (int k = 0; k < VEC; ++k) t[k] = w[k].out(i, t[k], METHOD, alpha);
      st_f32<VEC>(p, t);
    }
  }
}

// ---- grid B: every variable: its messages summed in edge order, then the
// prior; the last iteration writes the posterior and sets conv to 1 (row 0's
// items).  With no iteration at all (`none`), the posterior is the prior.
template <int VEC>
__global__ void __launch_bounds__(ROW_THREADS) bp_streamed_var_kernel(const FlatArgs a, bool last,
                                                                     bool none) {
  const size_t SS = (size_t)a.S;
  RowItems items(a.V, a.S, VEC);
  int v, s0;
  while (items.next(v, s0, VEC)) {
    if (v == 0 && last) stream_conv_one<VEC>(a.conv + s0);
    float* post = a.post + (size_t)v * SS + s0;
    const float pr = __ldg(&a.prior[v]);
    if (none) {
      float t[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) t[k] = pr;
      st_f32<VEC>(post, t);
      continue;
    }
    stream_var<VEC>(a.msg, 0, a.vm + (size_t)v * a.Dv, a.Dv, pr, SS, s0, last, post);
  }
}

// ---- the parity grid, once after the last iteration: the syndrome check
// of the final estimate; a violated check stores conv 0.
template <int VEC>
__global__ void __launch_bounds__(ROW_THREADS) bp_streamed_parity_kernel(const FlatArgs a) {
  const size_t SS = (size_t)a.S;
  RowItems items(a.C, a.S, VEC);
  int c, s0;
  while (items.next(c, s0, VEC)) {
    Pack<VEC> par = ld_raw_ro<VEC>(a.synd + (size_t)c * SS + s0);
    for (int i = 0; i < a.Dc; ++i) {
      const int v = __ldg(&a.chk_vars[(size_t)c * a.Dc + i]);
      if (v >= 0) stream_parity_xor<VEC>(par, a.post + (size_t)v * SS + s0);
    }
    stream_parity_store<VEC>(par, a.conv + s0);
  }
}

template <int MAXP, int VEC>
static void launch_checks(const FlatArgs& a, int method, float alpha, bool first, int blocks,
                          cudaStream_t st) {
  if (method == 0)
    bp_streamed_check_kernel<MAXP, VEC, 0><<<blocks, ROW_THREADS, 0, st>>>(a, alpha, first);
  else
    bp_streamed_check_kernel<MAXP, VEC, 1><<<blocks, ROW_THREADS, 0, st>>>(a, alpha, first);
}

// Grid A by padded check width and lane width (the plan's: 4 up to 16
// slots, 1 to 32, 4 on route "wide"); false where no instance exists.
static bool streamed_checks(const FlatArgs& a, int vec, int method, float alpha, bool first,
                            int blocks, bool wide, cudaStream_t st) {
  if (wide) {
    if (vec != 4) return false;
    if (method == 0)
      bp_streamed_check_wide_kernel<4, 0><<<blocks, ROW_THREADS, 0, st>>>(a, alpha, first);
    else
      bp_streamed_check_wide_kernel<4, 1><<<blocks, ROW_THREADS, 0, st>>>(a, alpha, first);
    return true;
  }
#define CASE(MAXP, VEC)                                            \
  if (a.Dc <= MAXP && vec == VEC) {                                \
    launch_checks<MAXP, VEC>(a, method, alpha, first, blocks, st); \
    return true;                                                   \
  }
  CASE(8, 4) CASE(16, 4) CASE(24, 1) CASE(32, 1)
#undef CASE
  return false;
}

// The whole decode on `stream`: max_iter iterations of grids A and B, then
// the parity grid (no iteration: grid B writes the priors as posteriors).
// The host reads nothing back.  S is the padded shot count (a multiple of
// 4); vec_a: grid A's lane width (the variable and parity grids take 4);
// blocks_*: each grid's blocks.
static int streamed(const FlatArgs& a, int max_iter, int method, float alpha0, bool wide,
                    int vec_a, int blocks_a, int blocks_b, int blocks_c, cudaStream_t st) {
  if (a.S % STREAM_SHOT_ALIGN || a.S % vec_a)
    return (int)cudaErrorInvalidValue;
  for (int it = 0; it < max_iter; ++it) {
    if (!streamed_checks(a, vec_a, method, stream_alpha(alpha0, it), it == 0, blocks_a, wide, st))
      return (int)cudaErrorInvalidValue;
    bp_streamed_var_kernel<4><<<blocks_b, ROW_THREADS, 0, st>>>(a, it == max_iter - 1, false);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (max_iter == 0)
    bp_streamed_var_kernel<4><<<blocks_b, ROW_THREADS, 0, st>>>(a, true, true);
  bp_streamed_parity_kernel<4><<<blocks_c, ROW_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
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
// device-memory scratch, S the padded shot count; vec_a: grid A's lane
// width; blocks_*: the blocks of grids A, B and the parity grid; no dynamic
// shared memory).  `wide`: route "wide" on either route, exactly where Dc exceeds
// MAX_SLOTS.
extern "C" int bp_fixed(const void* synd, const void* prior, const void* chk_vars, const void* vm,
                        void* msg, void* post, void* conv, int C, int V, int Dc, int Dv, int S,
                        int max_iter, int method, float alpha0, int group, int stride,
                        int threads, int tables_smem, int smem_bytes, int wide, int vec_a,
                        int blocks_a, int blocks_b, int blocks_c, void* stream) {
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
  const FlatArgs a = {sy, pr, cv, vt, (float*)msg, (float*)post, (uint8_t*)conv, C, V, Dc, Dv, S};
  return streamed(a, max_iter, method, alpha0, wide != 0, vec_a, blocks_a, blocks_b, blocks_c,
                  st);
}
