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
// Each check and each variable is computed by one thread in the plain
// version's order (no a*b+c contraction), so results are bit-identical to
// it.  Tensor cores have no role: the function holds no matrix product of
// its own (the TPU kernel's one-hot products are routing, done here by
// gathers through the Tanner tables).
//
// What bounds it on an H100.  A shot's state is every f32 message (B*r*Dc
// data, 2*R*r measurement) and its syndromes: 18,576 B at 4-round HGP-225,
// 304 MB at 16,384 shots, six times the L2.  Streamed through device memory
// (four passes per message per iteration) that is ~1.2 GB an iteration.  So
// the kernel has two routes, chosen in Python from the shape before the
// launch (utils/cuda_build.py::resident_plan):
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
// * streamed (stbp_streamed_kernel, the first port of this kernel) where one shot's
//   state exceeds the opt-in limit: a block owns 32 shots (one per lane:
//   every warp access is 32 consecutive shots of one row, coalesced) and
//   its 8 warps split each phase; the messages live in device memory,
//   updated in place.
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

// ---------------------------------------------------------------------------
// The streamed route
// ---------------------------------------------------------------------------

template <int MAXP, bool WIDE>
__global__ void __launch_bounds__(LANES* WORKERS) stbp_streamed_kernel(
    const uint8_t* __restrict__ synd,     // (B*r, S) 0/1
    const float* __restrict__ prior,      // (B*n + R*r,) LLRs
    const int* __restrict__ chk_vars_g,   // (r*Dc,), -1 = padded slot
    const int* __restrict__ vm_g,         // (n*Dv,), flat check-major slot, -1 = pad
    float* __restrict__ msg,              // (B*r*Dc, S) scratch
    float* __restrict__ mlo,              // (R*r, S) scratch: m_b <-> check block b
    float* __restrict__ mhi,              // (R*r, S) scratch: m_b <-> check block b+1
    float* __restrict__ post,             // (B*n + R*r, S) out
    uint8_t* __restrict__ conv,           // (S,) out
    int r, int n, int Dc, int Dv, int R, int S, int max_iter, int method, float alpha0,
    int tables_smem) {
  extern __shared__ int smem[];
  __shared__ int bad[LANES];
  const int lane = threadIdx.x;
  const int w = threadIdx.y;
  const int tid = w * LANES + lane;
  // the tables in shared memory where they fit (a warp reads one entry: a
  // broadcast), else through the read-only cache
  const int* chk_vars = chk_vars_g;
  const int* vm = vm_g;
  if (tables_smem) {
    for (int i = tid; i < r * Dc; i += LANES * WORKERS) smem[i] = chk_vars_g[i];
    for (int i = tid; i < n * Dv; i += LANES * WORKERS) smem[r * Dc + i] = vm_g[i];
    chk_vars = smem;
    vm = smem + r * Dc;
  }
  auto cvar = [&](int i) { return tables_smem ? chk_vars[i] : __ldg(&chk_vars_g[i]); };
  auto vmk = [&](int i) { return tables_smem ? vm[i] : __ldg(&vm_g[i]); };
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
        int v = cvar(c * Dc + i);
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
        const size_t e0 = (size_t)q * Dc;
        const size_t m_prev = (size_t)(q - r) * SS + s;  // m_{b-1}
        const size_t m_next = (size_t)q * SS + s;        // m_b
        const float vhi = (b > 0) ? mhi[m_prev] : BIG;
        const float vlo = (b < R) ? mlo[m_next] : BIG;
        if constexpr (WIDE) {  // the data slots, then the upper and the lower measurement slot
          WideCheck wk;
          wk.init(synd[(size_t)q * SS + s] ? -1.0f : 1.0f);
          for (int i = 0; i < Dc; ++i) wk.fold(i, msg[(e0 + i) * SS + s], method);
          wk.fold(Dc, vhi, method);
          wk.fold(Dc + 1, vlo, method);
          for (int i = 0; i < Dc; ++i) {
            if (cvar(c * Dc + i) < 0) continue;
            const size_t k = (e0 + i) * SS + s;
            msg[k] = wk.out(i, msg[k], method, alpha);
          }
          if (b > 0) mhi[m_prev] = wk.out(Dc, vhi, method, alpha);
          if (b < R) mlo[m_next] = wk.out(Dc + 1, vlo, method, alpha);
          continue;
        }
        float x[MAXP];
#pragma unroll
        for (int i = 0; i < MAXP; ++i)
          if (i < Dc) x[i] = msg[(e0 + i) * SS + s];
#pragma unroll
        for (int i = 0; i < MAXP; ++i) {
          if (i == Dc) x[i] = vhi;
          if (i == Dc + 1) x[i] = vlo;
        }
        const float ss = synd[(size_t)q * SS + s] ? -1.0f : 1.0f;
        check_update<MAXP>(x, P, ss, method, alpha);
#pragma unroll
        for (int i = 0; i < MAXP; ++i) {
          if (i < Dc && cvar(c * Dc + i) >= 0) msg[(e0 + i) * SS + s] = x[i];
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
          int k = vmk(v * Dv + j);
          if (k >= 0) total += msg[(eb + k) * SS + s];
        }
        const float pv = prior[bv] + total;
        if (last) post[(size_t)bv * SS + s] = pv;
        for (int j = 0; j < Dv; ++j) {
          int k = vmk(v * Dv + j);
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
        int v = cvar(c * Dc + i);
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

template <int MAXP, bool WIDE = false>
static int streamed(const uint8_t* synd, const float* prior, const int* chk_vars, const int* vm,
                    float* msg, float* mlo, float* mhi, float* post, uint8_t* conv, int r, int n,
                    int Dc, int Dv, int R, int S, int max_iter, int method, float alpha0,
                    int tables_smem, int smem_bytes, cudaStream_t stream) {
  const dim3 threads(LANES, WORKERS);
  const int blocks = (S + LANES - 1) / LANES;
  if (tables_smem && smem_bytes != (r * Dc + n * Dv) * (int)sizeof(int))
    return (int)cudaErrorInvalidValue;
  const int shmem = tables_smem ? smem_bytes : 0;
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(stbp_streamed_kernel<MAXP, WIDE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, shmem);
    if (e != cudaSuccess) return (int)e;
  }
  stbp_streamed_kernel<MAXP, WIDE><<<blocks, threads, shmem, stream>>>(
      synd, prior, chk_vars, vm, msg, mlo, mhi, post, conv, r, n, Dc, Dv, R, S, max_iter, method,
      alpha0, tables_smem);
  return (int)cudaGetLastError();
}

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
// must equal the layout's); group == 0: the streamed route (msg, mlo, mhi are
// its device-memory scratch; the tables in shared memory if tables_smem).
// `wide`: route "wide" on either route, exactly where Dc + 2 exceeds MAX_SLOTS.
extern "C" int stbp_fixed(const void* synd, const void* prior, const void* chk_vars,
                          const void* vm, void* msg, void* mlo, void* mhi, void* post, void* conv,
                          int r, int n, int Dc, int Dv, int R, int S, int max_iter, int method,
                          float alpha0, int group, int stride, int threads, int tables_smem,
                          int smem_bytes, int wide, void* stream) {
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
  auto go = [&](auto f) {
    return f(sy, pr, cv, vt, (float*)msg, (float*)mlo, (float*)mhi, (float*)post,
             (uint8_t*)conv, r, n, Dc, Dv, R, S, max_iter, method, alpha0, tables_smem,
             smem_bytes, st);
  };
  if (wide) return go([](auto... a) { return streamed<32, true>(a...); });
  if (P <= 8) return go([](auto... a) { return streamed<8>(a...); });
  if (P <= 16) return go([](auto... a) { return streamed<16>(a...); });
  if (P <= 32) return go([](auto... a) { return streamed<32>(a...); });
  return (int)cudaErrorInvalidValue;
}
