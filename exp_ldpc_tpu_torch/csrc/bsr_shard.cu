// K4: one flooding BP iteration for one check shard (check-partition BP).
//
// Replaces exp_ldpc_tpu/decoders/bp_bsr_shard.py::_kernel_iter (the Pallas
// kernel launched by bsr_shard_iter).  Same contract, computed by
// bsr_shard_iter_plain in decoders/bp_bsr_shard.py, which is this kernel's
// plain version:
//   * inputs: the replicated posterior (V_pad, S) f32, this shard's c2v
//     messages of the previous iteration (e_loc, S) bf16 (zeros at
//     iteration 0) and its syndromes (c_pad_loc, S); edge rows are
//     slot-major, row = slot * c_pad_loc + local check;
//   * broadcast: v2c = bf16((live ? bf16(posterior[var]) : 1e30) - c2v);
//     for min-sum a slot at or past its 128-check chunk's live-slot count
//     (a plane with no edge) is pinned to bf16(1e30) and left out of the
//     scan; sum-product scans all Dc slots;
//   * check update in f32 (check_update in spacetime_bp.cuh), c2v stored
//     bf16 in place of the v2c;
//   * partials: per variable, the f32 sum of its local c2v messages in edge
//     order, grouped by 128-row edge tile as the TPU kernel's tile products
//     group them, with no prior; 0 for a variable with no local edge.  The
//     caller adds the prior after summing the shards' partials.
//
// What bounds it on an H100: each launch streams the posterior (4 B per
// variable per shot) and the shard's messages (2 B per edge slot, read and
// written) and partials (4 B per variable), through dependent gathers:
// memory latency, not arithmetic.  Design: as K1 (bsr_bp.cu), a block owns
// 32 shots, one per lane, so every warp access is 32 consecutive shots of
// one row (coalesced); its SHARD_WARPS warps split phase A (broadcast and
// check update, one check per warp at a time) and phase B (partials, one
// variable per warp at a time) around one block barrier.  Phase B walks
// only the shard's variables that have a local edge and stores 0 for the
// rest.  The all-reduce of the partials over the model axis runs between
// launches (no collective runs inside a kernel), so there is one launch
// per iteration per shard.  Each check and variable is computed by one
// thread in the plain version's order, so results are bit-identical to it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "spacetime_bp.cuh"

#define SHARD_WARPS 32

__device__ __forceinline__ float bf(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

template <int MAXP>
__global__ void __launch_bounds__(LANES* SHARD_WARPS) bsr_shard_kernel(
    const int* __restrict__ chk_vars,     // (Dc*Cl,) slot-major, -1 = padded slot
    const int* __restrict__ nslot,        // (Cl,) slots scanned per check
    const int* __restrict__ lvar,         // (V_pad,) local variables first, then the rest
    const int* __restrict__ lvm,          // (n_loc*Dv,) local edge rows, -1 = pad
    const float* __restrict__ post,       // (V_pad, S)
    const __nv_bfloat16* msg_in,          // (Dc*Cl, S) c2v of the previous iteration
    const uint8_t* __restrict__ synd,     // (Cl, S)
    __nv_bfloat16* msg_out,               // (Dc*Cl, S) c2v out (may alias msg_in)
    float* __restrict__ part,             // (V_pad, S) out
    int Cl, int Dc, int V_pad, int n_loc, int Dv, int S, int method, float alpha) {
  const int lane = threadIdx.x;
  const int w = threadIdx.y;
  const int s = blockIdx.x * LANES + lane;
  const bool run = s < S;
  const size_t SS = (size_t)S;
  const __nv_bfloat16 big = __float2bfloat16_rn(BIG);

  // ---- phase A: broadcast and check update, one check at a time
  if (run) {
    for (int c = w; c < Cl; c += SHARD_WARPS) {
      const int ns = __ldg(&nslot[c]);
      float x[MAXP];
#pragma unroll
      for (int i = 0; i < MAXP; ++i) {
        if (i < ns) {
          const size_t row = (size_t)i * Cl + c;
          const int v = __ldg(&chk_vars[row]);
          const float a = (v >= 0) ? bf(post[(size_t)v * SS + s]) : BIG;
          x[i] = bf(a - __bfloat162float(msg_in[row * SS + s]));
        }
      }
      if (ns > 0) {
        const float ss = synd[(size_t)c * SS + s] ? -1.0f : 1.0f;
        check_update<MAXP>(x, ns, ss, method, alpha);
      }
#pragma unroll
      for (int i = 0; i < MAXP; ++i) {
        if (i < Dc) {
          const size_t row = (size_t)i * Cl + c;
          msg_out[row * SS + s] = (i < ns) ? __float2bfloat16_rn(x[i]) : big;
        }
      }
    }
  }
  __syncthreads();

  // ---- phase B: partial totals of the variables with a local edge
  if (run) {
    for (int i = w; i < n_loc; i += SHARD_WARPS) {
      float tot = 0.0f, tile = 0.0f;
      int cur = -1;
      for (int j = 0; j < Dv; ++j) {
        const int k = __ldg(&lvm[(size_t)i * Dv + j]);
        if (k < 0) break;
        const int et = k >> 7;  // 128-row edge tile
        if (et != cur) {
          if (cur >= 0) tot = tot + tile;
          tile = 0.0f;
          cur = et;
        }
        tile = tile + __bfloat162float(msg_out[(size_t)k * SS + s]);
      }
      if (cur >= 0) tot = tot + tile;
      part[(size_t)__ldg(&lvar[i]) * SS + s] = tot;
    }
    for (int i = n_loc + w; i < V_pad; i += SHARD_WARPS)
      part[(size_t)__ldg(&lvar[i]) * SS + s] = 0.0f;
  }
}

template <int MAXP>
static int launch(const int* chk_vars, const int* nslot, const int* lvar, const int* lvm,
                  const float* post, const __nv_bfloat16* msg_in, const uint8_t* synd,
                  __nv_bfloat16* msg_out, float* part, int Cl, int Dc, int V_pad, int n_loc,
                  int Dv, int S, int method, float alpha, cudaStream_t stream) {
  const dim3 threads(LANES, SHARD_WARPS);
  const int blocks = (S + LANES - 1) / LANES;
  bsr_shard_kernel<MAXP><<<blocks, threads, 0, stream>>>(chk_vars, nslot, lvar, lvm, post,
                                                        msg_in, synd, msg_out, part, Cl, Dc,
                                                        V_pad, n_loc, Dv, S, method, alpha);
  return (int)cudaGetLastError();
}

extern "C" int bsr_shard(const void* chk_vars, const void* nslot, const void* lvar,
                         const void* lvm, const void* post, const void* msg_in, const void* synd,
                         void* msg_out, void* part, int Cl, int Dc, int V_pad, int n_loc, int Dv,
                         int S, int method, float alpha, void* stream) {
  auto args = [&](auto f) {
    return f((const int*)chk_vars, (const int*)nslot, (const int*)lvar, (const int*)lvm,
             (const float*)post, (const __nv_bfloat16*)msg_in, (const uint8_t*)synd,
             (__nv_bfloat16*)msg_out, (float*)part, Cl, Dc, V_pad, n_loc, Dv, S, method, alpha,
             (cudaStream_t)stream);
  };
  if (Dc <= 8) return args([](auto... a) { return launch<8>(a...); });
  if (Dc <= 16) return args([](auto... a) { return launch<16>(a...); });
  if (Dc <= 32) return args([](auto... a) { return launch<32>(a...); });
  return (int)cudaErrorInvalidValue;
}
