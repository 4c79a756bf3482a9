// K2: fixed-iteration structured spacetime BP, f32, a whole decode in one call.
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
// Each check and each variable is computed by one thread in the plain
// version's order (no a*b+c contraction), so results are bit-identical to
// it.  Tensor cores have no role: the function holds no matrix product of
// its own (the TPU kernel's one-hot products are routing, done here by
// gathers through the Tanner tables).
//
// What bounds it on an H100.  A shot's state is every f32 message (B*r*Dc
// data, 2*R*r measurement) and its syndromes: 18,576 B at 4-round HGP-225,
// 304 MB at 16,384 shots, six times the L2.  So the kernel has two routes,
// chosen in Python from the shape before the launch
// (utils/cuda_build.py::resident_plan):
//
// * resident (stbp_resident_kernel): the Hopper counterpart of the TPU
//   kernel's VMEM scratch.  A block owns G shots and keeps all their
//   messages and syndromes in dynamic shared memory (up to the card's
//   opt-in limit, 227 KB on an H100) for every iteration: device memory
//   sees the syndromes and priors once and the posteriors and conv once.
//   The block's threads walk (row, shot) items, shots innermost, in three
//   phases per iteration (checks; measurement and data variables), with a
//   block barrier between; blocks never meet.  Messages are slot-major,
//   row i*B*r + q for slot i of check q, so a warp's check items read
//   consecutive words; the variable side gathers rows through the
//   variable->edge table.  The tables sit in shared memory where they fit
//   beside a shot, else they are read through the read-only cache.  What is
//   left is shared-memory bandwidth (~90 KB per shot per iteration) and
//   instruction throughput.
// * streamed (stbp_streamed_*_kernel) where one shot's state exceeds the
//   opt-in limit (the cyclic n = 4,862 and HGP n >= ~3,000 over 4 rounds):
//   the messages live in device memory, (row, S) shot-minor, and every
//   iteration reads and writes each of them twice (grid A, grid B): bound by
//   device-memory bandwidth.  K3's frame at f32 (csrc/streamed_bp.cuh):
//   each phase is one grid over a flat list of (row, 4 shots or 1) items,
//   sized from the item count and the SM count, so 685 shots of a large
//   code fill the card as 16,384 of a small one do.  Grid A updates every
//   check of every round block in place, the two measurement c2v messages
//   into mhi (m_{b-1}) / mlo (m_b) (the first iteration reads the priors
//   instead of initialised messages); grid B the measurement variables in
//   closed form and the data variables (the posteriors in the last
//   iteration); one spacetime parity grid follows the last iteration.  The
//   C entry point enqueues the whole decode (2 grids an iteration + 1); the
//   host reads nothing back.  The tables come through the read-only cache.
//
// Checks of more than MAX_SLOTS (32) slots, data and measurement slots
// together (Dc > 30, as in dense hypergraph products), take route "wide" on
// either route: the check phase in two passes over the slots (WideCheck,
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

struct StFArgs {
  const uint8_t* synd;    // (B*r, S) 0/1
  const float* prior;     // (B*n + R*r,) LLRs
  const int* chk_vars;    // (r*Dc,), -1 = padded slot
  const int* vm;          // (n*Dv,), flat check-major slot, -1 = pad
  float* msg;             // (B*r*Dc, S) scratch: data v2c in, v2c out (real slots only)
  float* mlo;             // (R*r, S) scratch: m_b <-> check block b
  float* mhi;             // (R*r, S) scratch: m_b <-> check block b+1
  float* post;            // (B*n + R*r, S) out
  uint8_t* conv;          // (S,) out
  int r, n, Dc, Dv, R, S;
};

// The two measurement slots of check q (block b) for VEC shots: mhi[m_{b-1}]
// and mlo[m_b] (their priors in the first iteration), +BIG at the boundary
// blocks.  Only check q reads or writes those two rows, so grid A updates
// them in place.
template <int VEC>
__device__ __forceinline__ void st_meas_in(const StFArgs& a, int q, int b, bool first,
                                           size_t SS, int s0, float (&vhi)[VEC],
                                           float (&vlo)[VEC]) {
  const float* mprior = a.prior + (size_t)(a.R + 1) * a.n;
#pragma unroll
  for (int k = 0; k < VEC; ++k) vhi[k] = vlo[k] = BIG;
  if (b > 0) {
    if (first) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) vhi[k] = __ldg(&mprior[q - a.r]);
    } else {
      ld_f32<VEC>(a.mhi + (size_t)(q - a.r) * SS + s0, vhi);
    }
  }
  if (b < a.R) {
    if (first) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) vlo[k] = __ldg(&mprior[q]);
    } else {
      ld_f32<VEC>(a.mlo + (size_t)q * SS + s0, vlo);
    }
  }
}

// ---- grid A: every check of every round block, in place: the data slots
// 0..Dc-1, then the upper (Dc) and the lower (Dc+1) measurement slot, the
// plain version's order.  x[VEC][MAXP] lives in registers: 4 shots a lane up
// to 16 slots; one above (two spilled, and ran 27-31% slower at the cyclic
// code's 26 slots on an H100).  Every slot is written and read back by selects on
// the unrolled index, never under a branch on it (a chain of `if (i == Dc)`
// stores becomes one store at a run-time index, in local memory).
template <int MAXP, int VEC, int METHOD>
__global__ void __launch_bounds__(ROW_THREADS, 2) stbp_streamed_check_kernel(const StFArgs a,
                                                                           float alpha,
                                                                           bool first) {
  const size_t SS = (size_t)a.S;
  const int Dc = a.Dc, P = a.Dc + 2, r = a.r, R = a.R;
  RowItems items((R + 1) * r, a.S, VEC);
  int q, s0;
  while (items.next(q, s0, VEC)) {
    const int b = q / r, c = q - b * r;
    const size_t e0 = (size_t)q * Dc;
    const int* cv = a.chk_vars + (size_t)c * Dc;
    const float* prior = a.prior + (size_t)b * a.n;
    float vhi[VEC], vlo[VEC], t[VEC];
    st_meas_in<VEC>(a, q, b, first, SS, s0, vhi, vlo);
    float x[VEC][MAXP];
#pragma unroll
    for (int i = 0; i < MAXP; ++i) {
      if (i < Dc) stream_slot<VEC>(__ldg(&cv[i]), first, prior, a.msg + (e0 + i) * SS + s0, t);
#pragma unroll
      for (int k = 0; k < VEC; ++k) x[k][i] = (i < Dc) ? t[k] : ((i == Dc) ? vhi[k] : vlo[k]);
    }
    const Pack<VEC> sy = ld_raw_ro<VEC>(a.synd + (size_t)q * SS + s0);
#pragma unroll
    for (int k = 0; k < VEC; ++k) check_update<MAXP>(x[k], P, sy.u8[k] ? -1.0f : 1.0f, METHOD, alpha);
#pragma unroll
    for (int i = 0; i < MAXP; ++i) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        vhi[k] = (i == Dc) ? x[k][i] : vhi[k];
        vlo[k] = (i == Dc + 1) ? x[k][i] : vlo[k];
      }
    }
#pragma unroll
    for (int i = 0; i < MAXP - 2; ++i) {
      if (i < Dc && __ldg(&cv[i]) >= 0) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) t[k] = x[k][i];
        st_f32<VEC>(a.msg + (e0 + i) * SS + s0, t);
      }
    }
    if (b > 0) st_f32<VEC>(a.mhi + (size_t)(q - r) * SS + s0, vhi);
    if (b < R) st_f32<VEC>(a.mlo + (size_t)q * SS + s0, vlo);
  }
}

// ---- grid A of route "wide" (more than MAX_SLOTS slots): two passes over
// the slots (WideCheck), whose registers do not grow with Dc: the data slots,
// then the upper and the lower measurement slot; pass 2 reads each live data
// slot again and stores its outgoing message in place.
template <int VEC, int METHOD>
__global__ void __launch_bounds__(ROW_THREADS) stbp_streamed_check_wide_kernel(const StFArgs a,
                                                                             float alpha,
                                                                             bool first) {
  const size_t SS = (size_t)a.S;
  const int Dc = a.Dc, r = a.r, R = a.R;
  RowItems items((R + 1) * r, a.S, VEC);
  int q, s0;
  while (items.next(q, s0, VEC)) {
    const int b = q / r, c = q - b * r;
    const size_t e0 = (size_t)q * Dc;
    const int* cv = a.chk_vars + (size_t)c * Dc;
    const float* prior = a.prior + (size_t)b * a.n;
    float vhi[VEC], vlo[VEC], t[VEC];
    st_meas_in<VEC>(a, q, b, first, SS, s0, vhi, vlo);
    const Pack<VEC> sy = ld_raw_ro<VEC>(a.synd + (size_t)q * SS + s0);
    WideCheck w[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) w[k].init(sy.u8[k] ? -1.0f : 1.0f);
    for (int i = 0; i < Dc; ++i) {
      stream_slot<VEC>(__ldg(&cv[i]), first, prior, a.msg + (e0 + i) * SS + s0, t);
#pragma unroll
      for (int k = 0; k < VEC; ++k) w[k].fold(i, t[k], METHOD);
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      w[k].fold(Dc, vhi[k], METHOD);
      w[k].fold(Dc + 1, vlo[k], METHOD);
    }
    for (int i = 0; i < Dc; ++i) {
      const int v = __ldg(&cv[i]);
      if (v < 0) continue;
      float* p = a.msg + (e0 + i) * SS + s0;
      stream_slot<VEC>(v, first, prior, p, t);
#pragma unroll
      for (int k = 0; k < VEC; ++k) t[k] = w[k].out(i, t[k], METHOD, alpha);
      st_f32<VEC>(p, t);
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      vhi[k] = w[k].out(Dc, vhi[k], METHOD, alpha);
      vlo[k] = w[k].out(Dc + 1, vlo[k], METHOD, alpha);
    }
    if (b > 0) st_f32<VEC>(a.mhi + (size_t)(q - r) * SS + s0, vhi);
    if (b < R) st_f32<VEC>(a.mlo + (size_t)q * SS + s0, vlo);
  }
}

// ---- grid B: the R*r measurement variables (closed form), then the B*n
// data variables (their messages summed in edge order, then the prior); the
// last iteration writes the posteriors and sets conv to 1 (row 0's items).
// With no iteration at all (`none`), the posterior is the prior.
template <int VEC>
__global__ void __launch_bounds__(ROW_THREADS) stbp_streamed_var_kernel(const StFArgs a,
                                                                       bool last, bool none) {
  const size_t SS = (size_t)a.S;
  const int n = a.n, nm = a.R * a.r, Vd = (a.R + 1) * n;
  RowItems items(nm + Vd, a.S, VEC);
  int u, s0;
  while (items.next(u, s0, VEC)) {
    if (u == 0 && last) stream_conv_one<VEC>(a.conv + s0);
    // posterior rows: data variables first, then measurement variables
    const int row = (u < nm) ? Vd + u : u - nm;
    float* post = a.post + (size_t)row * SS + s0;
    const float pr = __ldg(&a.prior[row]);
    if (none) {
      float t[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) t[k] = pr;
      st_f32<VEC>(post, t);
      continue;
    }
    if (u < nm) {
      const size_t idx = (size_t)u * SS + s0;
      float lo[VEC], hi[VEC], pm[VEC];
      ld_f32<VEC>(a.mlo + idx, lo);
      ld_f32<VEC>(a.mhi + idx, hi);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        pm[k] = (pr + lo[k]) + hi[k];
        lo[k] = pm[k] - lo[k];
        hi[k] = pm[k] - hi[k];
      }
      if (last) {
        st_f32<VEC>(post, pm);
      } else {
        st_f32<VEC>(a.mlo + idx, lo);
        st_f32<VEC>(a.mhi + idx, hi);
      }
      continue;
    }
    const int bv = u - nm, b = bv / n, v = bv - b * n;
    stream_var<VEC>(a.msg, (size_t)b * a.r * a.Dc, a.vm + (size_t)v * a.Dv, a.Dv, pr, SS, s0,
                    last, post);
  }
}

// ---- the parity grid, once after the last iteration: the spacetime
// syndrome check of the final estimate; a violated check stores conv 0.
template <int VEC>
__global__ void __launch_bounds__(ROW_THREADS) stbp_streamed_parity_kernel(const StFArgs a) {
  const size_t SS = (size_t)a.S;
  const int r = a.r, n = a.n, Dc = a.Dc, R = a.R;
  const size_t Vd = (size_t)(R + 1) * n;
  RowItems items((R + 1) * r, a.S, VEC);
  int q, s0;
  while (items.next(q, s0, VEC)) {
    const int b = q / r, c = q - b * r;
    Pack<VEC> par = ld_raw_ro<VEC>(a.synd + (size_t)q * SS + s0);
    for (int i = 0; i < Dc; ++i) {
      const int v = __ldg(&a.chk_vars[(size_t)c * Dc + i]);
      if (v >= 0) stream_parity_xor<VEC>(par, a.post + ((size_t)b * n + v) * SS + s0);
    }
    if (b > 0) stream_parity_xor<VEC>(par, a.post + (Vd + q - r) * SS + s0);
    if (b < R) stream_parity_xor<VEC>(par, a.post + (Vd + q) * SS + s0);
    stream_parity_store<VEC>(par, a.conv + s0);
  }
}

template <int MAXP, int VEC>
static void launch_checks(const StFArgs& a, int method, float alpha, bool first, int blocks,
                          cudaStream_t st) {
  if (method == 0)
    stbp_streamed_check_kernel<MAXP, VEC, 0><<<blocks, ROW_THREADS, 0, st>>>(a, alpha, first);
  else
    stbp_streamed_check_kernel<MAXP, VEC, 1><<<blocks, ROW_THREADS, 0, st>>>(a, alpha, first);
}

// Grid A by padded check width P = Dc + 2 and lane width (the plan's: 4 up
// to 16 slots, 1 to 32, 4 on route "wide"); false where no instance exists.
static bool streamed_checks(const StFArgs& a, int vec, int method, float alpha, bool first,
                            int blocks, bool wide, cudaStream_t st) {
  const int P = a.Dc + 2;
  if (wide) {
    if (vec != 4) return false;
    if (method == 0)
      stbp_streamed_check_wide_kernel<4, 0><<<blocks, ROW_THREADS, 0, st>>>(a, alpha, first);
    else
      stbp_streamed_check_wide_kernel<4, 1><<<blocks, ROW_THREADS, 0, st>>>(a, alpha, first);
    return true;
  }
#define CASE(MAXP, VEC)                                            \
  if (P <= MAXP && vec == VEC) {                                   \
    launch_checks<MAXP, VEC>(a, method, alpha, first, blocks, st); \
    return true;                                                   \
  }
  CASE(8, 4) CASE(10, 4) CASE(16, 4) CASE(24, 1) CASE(28, 1) CASE(32, 1)
#undef CASE
  return false;
}

// The whole decode on `stream`: max_iter iterations of grids A and B, then
// the parity grid (no iteration: grid B writes the priors as posteriors).
// The host reads nothing back.  S is the padded shot count (a multiple of
// 4); vec_a: grid A's lane width (the variable and parity grids take 4);
// blocks_*: each grid's blocks.
static int streamed(const StFArgs& a, int max_iter, int method, float alpha0, bool wide,
                    int vec_a, int blocks_a, int blocks_b, int blocks_c, cudaStream_t st) {
  if (a.S % STREAM_SHOT_ALIGN || a.S % vec_a)
    return (int)cudaErrorInvalidValue;
  for (int it = 0; it < max_iter; ++it) {
    if (!streamed_checks(a, vec_a, method, stream_alpha(alpha0, it), it == 0, blocks_a, wide, st))
      return (int)cudaErrorInvalidValue;
    stbp_streamed_var_kernel<4><<<blocks_b, ROW_THREADS, 0, st>>>(a, it == max_iter - 1, false);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (max_iter == 0)
    stbp_streamed_var_kernel<4><<<blocks_b, ROW_THREADS, 0, st>>>(a, true, true);
  stbp_streamed_parity_kernel<4><<<blocks_c, ROW_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The resident route
// ---------------------------------------------------------------------------

// Dynamic shared memory of a resident block, in this order (4-byte words,
// then bytes), each per-shot array [row][stride]:
//   msg  Dc*B*r rows (slot-major: row i*B*r + q)  f32
//   mlo, mhi  R*r rows each                         f32
//   bad  stride                                     i32 (per-shot flag)
//   live r                                          i32 (bit i: slot i is an edge)
//   [chk_vars r*Dc, vm n*Dv]  when tables_smem      i32 (vm as slot-major rows)
//   sy   B*r rows                                   u8
// decoders/spacetime_bp_cuda.py::resident_bytes computes the same sizes.
static size_t stbp_resident_bytes(int r, int n, int Dc, int Dv, int R, int stride,
                                  int tables_smem) {
  const size_t Q = (size_t)(R + 1) * r;
  const size_t words = ((size_t)Dc * Q + 2 * (size_t)R * r + 1) * stride + r +
                       (tables_smem ? (size_t)r * Dc + (size_t)n * Dv : 0);
  return 4 * words + Q * stride;
}

template <int MAXP, bool EXACT, bool WIDE>
__global__ void __launch_bounds__(ResidentThreads<MAXP>::value) stbp_resident_kernel(
    const uint8_t* __restrict__ synd,     // (B*r, S) 0/1
    const float* __restrict__ prior,      // (B*n + R*r,) LLRs
    const int* __restrict__ chk_vars_g,   // (r*Dc,), -1 = padded slot
    const int* __restrict__ vm_g,         // (n*Dv,), flat check-major slot, -1 = pad
    float* __restrict__ post,             // (B*n + R*r, S) out
    uint8_t* __restrict__ conv,           // (S,) out
    int r, int n, int Dc_rt, int Dv, int R, int S, int max_iter, int method, float alpha0,
    int G, int stride, int tables_smem) {
  extern __shared__ float4 smem4[];
  // exact-width instances fix the check width (Dc data + 2 measurement slots)
  const int Dc = EXACT ? MAXP - 2 : Dc_rt;
  const int P = Dc + 2;
  const int B = R + 1, Q = B * r, nm = R * r, Vd = B * n;
  const int s0 = blockIdx.x * G;
  const int Gb = min(G, S - s0);  // the last block may hold fewer shots
  const size_t SS = (size_t)S;
  const int T = blockDim.x, tid = threadIdx.x;

  float* msg = reinterpret_cast<float*>(smem4);
  float* mlo = msg + Dc * Q * stride;
  float* mhi = mlo + nm * stride;
  int* bad = reinterpret_cast<int*>(mhi + nm * stride);
  int* live = bad + stride;
  int* chk_vars = live + r;
  int* vm = chk_vars + (tables_smem ? r * Dc : 0);
  uint8_t* sy = reinterpret_cast<uint8_t*>(vm + (tables_smem ? n * Dv : 0));
  const float* mprior = prior + Vd;

  // an edge of the variable->edge table as a slot-major row of base block 0
  auto remap = [&](int k) { return k < 0 ? -1 : (k % Dc) * Q + k / Dc; };
  for (int c = tid; c < r && !WIDE; c += T) {  // route "wide" reads the tables' sentinel
    int m = 0;
    for (int i = 0; i < Dc; ++i)
      if (__ldg(&chk_vars_g[c * Dc + i]) >= 0) m |= 1 << i;
    live[c] = m;
  }
  if (tables_smem) {
    for (int i = tid; i < r * Dc; i += T) chk_vars[i] = __ldg(&chk_vars_g[i]);
    for (int i = tid; i < n * Dv; i += T) vm[i] = remap(__ldg(&vm_g[i]));
  }
  for (int g = tid; g < stride; g += T) bad[g] = 0;
  __syncthreads();  // the tables, before any thread reads them
  auto cvar = [&](int i) { return tables_smem ? chk_vars[i] : __ldg(&chk_vars_g[i]); };
  auto vmk = [&](int i) { return tables_smem ? vm[i] : remap(__ldg(&vm_g[i])); };

  // init: v2c = priors, syndromes in; posterior = priors if max_iter == 0
  walk(B, r, Gb, [&](int b, int c, int g) {
    const int q = b * r + c;
    for (int i = 0; i < Dc; ++i) {
      const int v = cvar(c * Dc + i);
      msg[(i * Q + q) * stride + g] = (v >= 0) ? __ldg(&prior[b * n + v]) : BIG;
    }
    sy[q * stride + g] = synd[(size_t)q * SS + s0 + g];
  });
  walk(1, nm, Gb, [&](int, int m, int g) {
    const float pm = __ldg(&mprior[m]);
    mlo[m * stride + g] = pm;
    mhi[m * stride + g] = pm;
  });
  if (max_iter == 0)
    walk(1, Vd + nm, Gb,
         [&](int, int u, int g) { post[(size_t)u * SS + s0 + g] = __ldg(&prior[u]); });
  __syncthreads();

  for (int it = 0; it < max_iter; ++it) {
    const float alpha = (alpha0 == 0.0f) ? 1.0f - ldexpf(1.0f, -(it + 1)) : alpha0;
    const bool last = (it == max_iter - 1);
    // ---- checks of every round block; the two measurement c2v messages go
    // in place into mhi (m_{b-1}) / mlo (m_b)
    walk(B, r, Gb, [&](int b, int c, int g) {
      const int q = b * r + c;
      const int iprev = (q - r) * stride + g, inext = q * stride + g;
      const float vhi = (b > 0) ? mhi[iprev] : BIG;
      const float vlo = (b < R) ? mlo[inext] : BIG;
      if constexpr (WIDE) {  // the data slots, then the upper and the lower measurement slot
        WideCheck wk;
        wk.init(sy[q * stride + g] ? -1.0f : 1.0f);
        for (int i = 0; i < Dc; ++i) wk.fold(i, msg[(i * Q + q) * stride + g], method);
        wk.fold(Dc, vhi, method);
        wk.fold(Dc + 1, vlo, method);
        for (int i = 0; i < Dc; ++i) {
          if (cvar(c * Dc + i) < 0) continue;
          const int k = (i * Q + q) * stride + g;
          msg[k] = wk.out(i, msg[k], method, alpha);
        }
        if (b > 0) mhi[iprev] = wk.out(Dc, vhi, method, alpha);
        if (b < R) mlo[inext] = wk.out(Dc + 1, vlo, method, alpha);
        return;
      }
      float x[MAXP];
#pragma unroll
      for (int i = 0; i < MAXP; ++i)
        if (i < Dc) x[i] = msg[(i * Q + q) * stride + g];
      if constexpr (EXACT) {
        x[MAXP - 2] = vhi;
        x[MAXP - 1] = vlo;
      } else {
#pragma unroll
        for (int i = 0; i < MAXP; ++i) {
          if (i == Dc) x[i] = vhi;
          if (i == Dc + 1) x[i] = vlo;
        }
      }
      const float ss = sy[q * stride + g] ? -1.0f : 1.0f;
      check_update<MAXP>(x, P, ss, method, alpha);
      const int lv = live[c];
#pragma unroll
      for (int i = 0; i < MAXP; ++i)
        if (i < Dc && ((lv >> i) & 1)) msg[(i * Q + q) * stride + g] = x[i];
      if constexpr (EXACT) {
        if (b > 0) mhi[iprev] = x[MAXP - 2];
        if (b < R) mlo[inext] = x[MAXP - 1];
      } else {
#pragma unroll
        for (int i = 0; i < MAXP; ++i) {
          if (i == Dc && b > 0) mhi[iprev] = x[i];
          if (i == Dc + 1 && b < R) mlo[inext] = x[i];
        }
      }
    });
    __syncthreads();
    // ---- measurement variables (closed form), then data variables; the
    // last iteration writes the posteriors and leaves the messages
    walk(1, nm, Gb, [&](int, int m, int g) {
      const int idx = m * stride + g;
      const float lo = mlo[idx], hi = mhi[idx];
      const float pm = (__ldg(&mprior[m]) + lo) + hi;
      if (last) {
        post[((size_t)Vd + m) * SS + s0 + g] = pm;
      } else {
        mlo[idx] = pm - lo;
        mhi[idx] = pm - hi;
      }
    });
    walk(B, n, Gb, [&](int b, int v, int g) {
      const int boff = b * r;
      float gv[8];
      int kk[8];
      float total = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < Dv) {
          kk[j] = vmk(v * Dv + j);
          if (kk[j] >= 0) {
            gv[j] = msg[(kk[j] + boff) * stride + g];
            total += gv[j];
          }
        }
      }
      for (int j = 8; j < Dv; ++j) {
        const int k = vmk(v * Dv + j);
        if (k >= 0) total += msg[(k + boff) * stride + g];
      }
      const float pv = __ldg(&prior[b * n + v]) + total;
      if (last) {
        post[(size_t)(b * n + v) * SS + s0 + g] = pv;
        return;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j < Dv && kk[j] >= 0) msg[(kk[j] + boff) * stride + g] = pv - gv[j];
      for (int j = 8; j < Dv; ++j) {
        const int k = vmk(v * Dv + j);
        if (k >= 0) {
          const int idx = (k + boff) * stride + g;
          msg[idx] = pv - msg[idx];
        }
      }
    });
    __syncthreads();
  }

  // ---- spacetime syndrome check of the final estimate (the block's own
  // posterior writes, visible after the barrier)
  walk(B, r, Gb, [&](int b, int c, int g) {
    const int q = b * r + c;
    const size_t s = (size_t)s0 + g;
    int par = sy[q * stride + g];
    for (int i = 0; i < Dc; ++i) {
      const int v = cvar(c * Dc + i);
      if (v >= 0) par ^= (post[(size_t)(b * n + v) * SS + s] <= 0.0f);
    }
    if (b > 0) par ^= (post[((size_t)Vd + q - r) * SS + s] <= 0.0f);
    if (b < R) par ^= (post[((size_t)Vd + q) * SS + s] <= 0.0f);
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
                    float* post, uint8_t* conv, int r, int n, int Dc, int Dv, int R, int S,
                    int max_iter, int method, float alpha0, int G, int stride, int threads,
                    int tables_smem, int smem_bytes, cudaStream_t stream) {
  if (threads > ResidentThreads<MAXP>::value || G < 1 || stride < G ||
      (size_t)smem_bytes != stbp_resident_bytes(r, n, Dc, Dv, R, stride, tables_smem))
    return (int)cudaErrorInvalidValue;
  return launch_resident(stbp_resident_kernel<MAXP, EXACT, WIDE>, (S + G - 1) / G, threads,
                         smem_bytes, stream, synd, prior, chk_vars, vm, post, conv, r, n, Dc, Dv,
                         R, S, max_iter, method, alpha0, G, stride, tables_smem);
}

// group > 0: the resident route (group shots per block, rows of `stride`
// slots, `threads` per block, `smem_bytes` of dynamic shared memory, which
// must equal the layout's); group == 0: the streamed route (msg, mlo, mhi
// are its device-memory scratch, S the padded shot count; vec_a: grid A's
// lane width; blocks_*: the blocks of grids A, B and the parity grid; the
// tables through the read-only cache).  `wide`: route "wide" on either route, exactly where
// Dc + 2 exceeds MAX_SLOTS.
extern "C" int stbp_fixed(const void* synd, const void* prior, const void* chk_vars,
                          const void* vm, void* msg, void* mlo, void* mhi, void* post, void* conv,
                          int r, int n, int Dc, int Dv, int R, int S, int max_iter, int method,
                          float alpha0, int group, int stride, int threads, int tables_smem,
                          int smem_bytes, int wide, int vec_a, int blocks_a, int blocks_b,
                          int blocks_c, void* stream) {
  const int P = Dc + 2;
  if ((wide != 0) != (P > MAX_SLOTS)) return (int)cudaErrorInvalidValue;
  const uint8_t* sy = (const uint8_t*)synd;
  const float* pr = (const float*)prior;
  const int* cv = (const int*)chk_vars;
  const int* vt = (const int*)vm;
  cudaStream_t st = (cudaStream_t)stream;
  if (group > 0) {
    auto go = [&](auto f) {
      return f(sy, pr, cv, vt, (float*)post, (uint8_t*)conv, r, n, Dc, Dv, R, S, max_iter,
               method, alpha0, group, stride, threads, tables_smem, smem_bytes, st);
    };
    if (wide) return go([](auto... a) { return resident<32, false, true>(a...); });
    // exact widths: HGP's Dc 7 (+2) and the gross code's Dc 6 (+2)
    if (P == 9) return go([](auto... a) { return resident<9, true>(a...); });
    if (P == 8) return go([](auto... a) { return resident<8, true>(a...); });
    if (P < 8) return go([](auto... a) { return resident<8, false>(a...); });
    if (P <= 16) return go([](auto... a) { return resident<16, false>(a...); });
    if (P <= 32) return go([](auto... a) { return resident<32, false>(a...); });
    return (int)cudaErrorInvalidValue;
  }
  const StFArgs a = {sy, pr, cv, vt, (float*)msg, (float*)mlo, (float*)mhi, (float*)post,
                     (uint8_t*)conv, r, n, Dc, Dv, R, S};
  return streamed(a, max_iter, method, alpha0, wide != 0, vec_a, blocks_a, blocks_b, blocks_c,
                  st);
}
