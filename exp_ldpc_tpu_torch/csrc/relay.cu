// K10: the relay BP ensemble (arXiv:2507.00254), a whole decode in one launch.
//
// Same contract as decoders/relay_bp.py::relay_core, which is this kernel's
// plain version (the JAX package runs the ensemble on XLA: there is no TPU
// kernel):
//   * f32 messages in the TannerELL check-major layout, padded slots held at
//     +1e30; min-sum with the fixed alpha, or the adaptive 1 - 2^-(t+1) when
//     alpha0 == 0, t restarting at every leg;
//   * the variable update keeps a memory term,
//       lam_j(t) = (1 - g_j) * (prior_j + sum_i c2v_ij) + g_j * lam_j(t-1),
//     the messages summed in edge order, g the leg's row of the (legs, V)
//     gamma table; v2c = lam[var] - c2v;
//   * the message state and lam carry over from one leg to the next; a shot
//     keeps the outputs of the first leg whose hard decision (lam <= 0)
//     satisfies its syndrome, and a shot no leg solved reports the last
//     leg's lam.
// Each check and variable is computed by one thread in the plain version's
// order, with no a*b+c contraction, so results are bit-identical to it.
//
// Why one kernel.  The plain version runs ~10 PyTorch launches an
// iteration over (checks, slots, shots) tensors in device memory (a few GB
// an iteration at the gross code over 12 rounds and 20,000 shots), every
// leg on every shot until the whole batch has converged, and reads a flag
// back each leg.  Here a block keeps its shots' messages and lam in shared
// memory for the whole decode (K6's resident layout, csrc/bpflat.cu: rows
// [row][G], shots innermost, the tables in shared memory where they
// fit beside a shot), tests the syndrome of each of its shots at each leg's
// end, and drops the solved ones: a solved shot's outputs never change
// after its leg, so the per-shot exit is exact and nothing is read back.
//
// The work is uneven: leg 0 runs on every shot, the later legs on the few
// per cent of shots leg 0 leaves unsolved, up to (legs - 1) x iters more
// iterations each.  So the grid is one wave of persistent blocks of G slots
// that take the batch's shots from a queue (`head`): each slot takes the
// next shot when its own shot is done, at a leg boundary (every slot of a
// block is at the same iteration of its leg, whatever its leg), so a hard
// shot holds one slot and not a whole block.  Each leg walks only the
// block's live slots (`act`).  (Blocks that each keep G shots of their own
// and end when the last is done ran 3% slower at the gross code x 12.)
//
// Checks of more than MAX_SLOTS (32) slots take route "wide": the check
// phase in two passes over the slots (WideCheck, spacetime_bp.cuh), the live
// slots read from the tables' -1 sentinel.  The caller's plan names the
// route and the entry point refuses one that does not match the degree.
#include <cuda_runtime.h>
#include <stdint.h>

#include "resident_bp.cuh"
#include "spacetime_bp.cuh"

// Dynamic shared memory of a block, in this order (4-byte words, then
// bytes), each per-slot array [row][G]:
//   msg   Dc*C rows (slot-major: row i*C + c)            f32
//   lam   V rows                                          f32
//   shot, leg, bad, lst   G each                          i32 (a slot's shot (-1: idle), its
//                                                         leg, its parity flag; a slot list)
//   act   G                                               i32 (the live slots)
//   ctl   4                                               i32 (list lengths)
//   live  C                                               i32 (bit i: slot i is an edge)
//   [chk_vars C*Dc, vm V*Dv]  when tables_smem            i32 (vm as slot-major rows)
//   sy    C rows                                          u8
// decoders/relay_cuda.py::relay_bytes computes the same sizes.
static size_t relay_bytes(int C, int V, int Dc, int Dv, int G, int tables_smem) {
  const size_t words = ((size_t)Dc * C + V + 5) * G + 4 + C +
                       (tables_smem ? (size_t)C * Dc + (size_t)V * Dv : 0);
  return 4 * words + (size_t)C * G;
}

template <int MAXP, bool WIDE>
__global__ void __launch_bounds__(ResidentThreads<MAXP>::value) k10_relay_kernel(
    const uint8_t* __restrict__ synd,     // (C, S) 0/1
    const float* __restrict__ prior,      // (V,) LLRs
    const float* __restrict__ gammas,     // (L, V) memory strengths
    const int* __restrict__ chk_vars_g,   // (C*Dc,), -1 = padded slot
    const int* __restrict__ vm_g,         // (V*Dv,), flat check-major slot, -1 = pad
    float* __restrict__ post,             // (V, S) out
    uint8_t* __restrict__ conv,           // (S,) out
    int* __restrict__ solved,             // (S,) out: the solving leg, L where none
    int* __restrict__ head,               // the queue's next shot, zeroed
    int C, int V, int Dc_rt, int Dv, int S, int L, int iters, float alpha0, int G,
    int tables_smem) {
  extern __shared__ float4 smem4[];
  const int Dc = Dc_rt;
  const size_t SS = (size_t)S;
  const int T = blockDim.x, tid = threadIdx.x;

  float* msg = reinterpret_cast<float*>(smem4);
  float* lam = msg + (size_t)Dc * C * G;
  int* shot = reinterpret_cast<int*>(lam + (size_t)V * G);
  int* leg = shot + G;
  int* bad = leg + G;
  int* lst = bad + G;
  int* act = lst + G;
  int* ctl = act + G;   // [0] live slots, [1] listed slots
  int* live = ctl + 4;
  int* chk_vars = live + C;
  int* vm = chk_vars + (tables_smem ? C * Dc : 0);
  uint8_t* sy = reinterpret_cast<uint8_t*>(vm + (tables_smem ? V * Dv : 0));

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
  auto cvar = [&](int i) { return tables_smem ? chk_vars[i] : __ldg(&chk_vars_g[i]); };
  auto vmk = [&](int i) { return tables_smem ? vm[i] : remap(__ldg(&vm_g[i])); };

  // Hand the slots in lst[0..n) the next n shots of the queue (all slots at
  // the start); a slot that gets a shot starts at leg 0 and stays in lst, a
  // slot past the batch's end goes idle.  One thread.
  auto take = [&](int n) {
    const int base = n > 0 ? atomicAdd(head, n) : S;
    int kept = 0;
    for (int k = 0; k < n; ++k) {
      const int g = lst[k];
      const int s = base + k < S ? base + k : -1;
      shot[g] = s;
      leg[g] = 0;
      if (s >= 0) lst[kept++] = g;
    }
    ctl[1] = kept;
  };
  if (tid == 0) {
    for (int g = 0; g < G; ++g) lst[g] = g;
    take(G);
  }
  __syncthreads();

  while (true) {
    // ---- the live slots; the fresh ones (lst) start from the priors
    if (tid == 0) {
      int n = 0;
      for (int g = 0; g < G; ++g) {
        bad[g] = 0;
        if (shot[g] >= 0) act[n++] = g;
      }
      ctl[0] = n;
    }
    __syncthreads();
    const int na = ctl[0], nf = ctl[1];
    if (na == 0) break;
    if (nf > 0) walk(1, C, nf, [&](int, int c, int a) {
      const int g = lst[a];
      for (int i = 0; i < Dc; ++i) {
        const int v = cvar(c * Dc + i);
        msg[(i * C + c) * G + g] = (v >= 0) ? __ldg(&prior[v]) : BIG;
      }
      sy[c * G + g] = synd[(size_t)c * SS + shot[g]];
    });
    if (nf > 0)
      walk(1, V, nf, [&](int, int v, int a) { lam[v * G + lst[a]] = __ldg(&prior[v]); });
    __syncthreads();

    // ---- one leg of every live slot
    for (int it = 0; it < iters; ++it) {
      const float alpha = (alpha0 == 0.0f) ? 1.0f - ldexpf(1.0f, -(it + 1)) : alpha0;
      // checks, in place (padded slots stay +BIG)
      walk(1, C, na, [&](int, int c, int a) {
        const int g = act[a];
        const float ss = sy[c * G + g] ? -1.0f : 1.0f;
        if constexpr (WIDE) {
          WideCheck wk;
          wk.init(ss);
          for (int i = 0; i < Dc; ++i) wk.fold(i, msg[(i * C + c) * G + g], 1);
          for (int i = 0; i < Dc; ++i) {
            if (cvar(c * Dc + i) < 0) continue;
            const int k = (i * C + c) * G + g;
            msg[k] = wk.out(i, msg[k], 1, alpha);
          }
          return;
        }
        float x[MAXP];
#pragma unroll
        for (int i = 0; i < MAXP; ++i)
          if (i < Dc) x[i] = msg[(i * C + c) * G + g];
        check_update<MAXP>(x, Dc, ss, 1, alpha);
        const int lv = live[c];
#pragma unroll
        for (int i = 0; i < MAXP; ++i)
          if (i < Dc && ((lv >> i) & 1)) msg[(i * C + c) * G + g] = x[i];
      });
      __syncthreads();
      // variables: edges summed in order, the prior, the memory term
      walk(1, V, na, [&](int, int v, int a) {
        const int g = act[a];
        float gv[8];
        int kk[8];
        float total = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j < Dv) {
            kk[j] = vmk(v * Dv + j);
            if (kk[j] >= 0) {
              gv[j] = msg[kk[j] * G + g];
              total += gv[j];
            }
          }
        }
        for (int j = 8; j < Dv; ++j) {
          const int k = vmk(v * Dv + j);
          if (k >= 0) total += msg[k * G + g];
        }
        const float gm = __ldg(&gammas[(size_t)leg[g] * V + v]);
        const float pv = __ldg(&prior[v]) + total;
        const float lm = (1.0f - gm) * pv + gm * lam[v * G + g];
        lam[v * G + g] = lm;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (j < Dv && kk[j] >= 0) msg[kk[j] * G + g] = lm - gv[j];
        for (int j = 8; j < Dv; ++j) {
          const int k = vmk(v * Dv + j);
          if (k >= 0) msg[k * G + g] = lm - msg[k * G + g];
        }
      });
      __syncthreads();
    }

    // ---- the leg's end: each live slot's syndrome under its hard decision
    walk(1, C, na, [&](int, int c, int a) {
      const int g = act[a];
      int par = sy[c * G + g];
      for (int i = 0; i < Dc; ++i) {
        const int v = cvar(c * Dc + i);
        if (v >= 0) par ^= (lam[v * G + g] <= 0.0f);
      }
      if (par) bad[g] = 1;
    });
    __syncthreads();
    // a slot is done where its leg solved its shot or was the last
    if (tid == 0) {
      int n = 0;
      for (int a = 0; a < na; ++a) {
        const int g = act[a], s = shot[g];
        if (!bad[g] || leg[g] == L - 1) {
          conv[s] = bad[g] ? 0 : 1;
          solved[s] = bad[g] ? L : leg[g];
          lst[n++] = g;
        } else {
          ++leg[g];
        }
      }
      ctl[1] = n;
    }
    __syncthreads();
    const int nd = ctl[1];
    if (nd > 0) walk(1, V, nd, [&](int, int v, int a) {
      const int g = lst[a];
      post[(size_t)v * SS + shot[g]] = lam[v * G + g];
    });
    __syncthreads();
    if (tid == 0) take(nd);
    __syncthreads();
  }
}

template <int MAXP, bool WIDE = false>
static int relay(const uint8_t* synd, const float* prior, const float* gammas, const int* chk_vars,
                 const int* vm, float* post, uint8_t* conv, int* solved, int* head, int C, int V,
                 int Dc, int Dv, int S, int L, int iters, float alpha0, int G, int threads,
                 int tables_smem, int smem_bytes, int blocks, cudaStream_t stream) {
  if (threads > ResidentThreads<MAXP>::value || G < 1 || blocks < 1 ||
      (size_t)smem_bytes != relay_bytes(C, V, Dc, Dv, G, tables_smem))
    return (int)cudaErrorInvalidValue;
  return launch_resident(k10_relay_kernel<MAXP, WIDE>, blocks, threads, smem_bytes, stream, synd,
                         prior, gammas, chk_vars, vm, post, conv, solved, head, C, V, Dc, Dv, S,
                         L, iters, alpha0, G, tables_smem);
}

// One decode of S shots (min-sum; L >= 1 legs of `iters` iterations):
// `blocks` blocks of `group` slots, `threads` a block, `smem_bytes` of
// dynamic shared memory, which must equal the layout's.  `head` (4 bytes of
// device memory) is the queue of shots, which this call zeroes on `stream`
// first.  `wide`: route "wide", exactly where Dc exceeds MAX_SLOTS.
extern "C" int relay_decode(const void* synd, const void* prior, const void* gammas,
                            const void* chk_vars, const void* vm, void* post, void* conv,
                            void* solved, void* head, int C, int V, int Dc, int Dv, int S, int L,
                            int iters, float alpha0, int group, int threads, int tables_smem,
                            int smem_bytes, int blocks, int wide, void* stream) {
  if ((wide != 0) != (Dc > MAX_SLOTS) || L < 1 || iters < 0 || S < 1 || head == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = cudaMemsetAsync(head, 0, sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  auto go = [&](auto f) {
    return f((const uint8_t*)synd, (const float*)prior, (const float*)gammas,
             (const int*)chk_vars, (const int*)vm, (float*)post, (uint8_t*)conv, (int*)solved,
             (int*)head, C, V, Dc, Dv, S, L, iters, alpha0, group, threads, tables_smem,
             smem_bytes, blocks, st);
  };
  if (wide) return go([](auto... a) { return relay<32, true>(a...); });
  if (Dc <= 8) return go([](auto... a) { return relay<8>(a...); });
  if (Dc <= 16) return go([](auto... a) { return relay<16>(a...); });
  if (Dc <= 32) return go([](auto... a) { return relay<32>(a...); });
  return (int)cudaErrorInvalidValue;
}
