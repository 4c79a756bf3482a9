// Shared device code of the spacetime BP kernels K2 (stbp.cu) and K3
// (stbsr.cu): the check-node update, which both compute exactly as the plain
// PyTorch version decoders/bp.py::check_update_cm does.
#pragma once

#include <cuda_runtime.h>

#define BIG 1e30f
#define MAX_SLOTS 32  // the widest check of every kernel's register instances; wider: route "wide"
#define LANES 32   // shots per block: one per lane, so warp accesses coalesce
#define WORKERS 8  // warps per block, splitting each phase of an iteration

__device__ __forceinline__ float phi_f(float x) {
  x = fminf(fmaxf(x, 1e-7f), 30.0f);
  return -logf(tanhf(x * 0.5f));
}

// Check update of one check's P incoming messages x[0..P-1], in place.
// Mirrors decoders/bp.py::check_update_cm: signs exclude self, sums left to
// right, ms ties go to the first minimum.
template <int MAXP>
__device__ __forceinline__ void check_update(float (&x)[MAXP], int P, float synd_sign,
                                             int method, float alpha) {
  float tsign = synd_sign;
#pragma unroll
  for (int i = 0; i < MAXP; ++i)
    if (i < P && x[i] < 0.0f) tsign = -tsign;
  if (method == 0) {  // ps
    float ph[MAXP];
    float total = 0.0f;
#pragma unroll
    for (int i = 0; i < MAXP; ++i) {
      if (i < P) {
        ph[i] = phi_f(fabsf(x[i]));
        total = (i == 0) ? ph[i] : total + ph[i];
      }
    }
#pragma unroll
    for (int i = 0; i < MAXP; ++i) {
      if (i < P) {
        float s = (x[i] < 0.0f) ? -tsign : tsign;
        x[i] = s * phi_f(total - ph[i]);
      }
    }
  } else {  // ms
    float min1 = BIG, min2 = BIG;
    int arg = -1;
#pragma unroll
    for (int i = 0; i < MAXP; ++i) {
      if (i < P) {
        float m = fabsf(x[i]);
        if (arg < 0 || m < min1) {
          min2 = (arg < 0) ? min2 : min1;
          min1 = m;
          arg = i;
        } else {
          min2 = fminf(min2, m);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MAXP; ++i) {
      if (i < P) {
        float s = (x[i] < 0.0f) ? -tsign : tsign;
        x[i] = (s * ((i == arg) ? min2 : min1)) * alpha;
      }
    }
  }
}

// Min-sum update of all N slots, for callers that pad unused slots with
// +infinity: such a slot flips no sign and never enters min1 or min2 (slot 0
// is always a real one), so the result on the real slots is check_update's
// with P = the real count, without a run-time bound on any loop.
template <int N>
__device__ __forceinline__ void check_update_ms_all(float (&x)[N], float synd_sign, float alpha) {
  float tsign = synd_sign;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (x[i] < 0.0f) tsign = -tsign;
  float min1 = fabsf(x[0]), min2 = BIG;
  int arg = 0;
#pragma unroll
  for (int i = 1; i < N; ++i) {
    const float m = fabsf(x[i]);
    if (m < min1) {
      min2 = min1;
      min1 = m;
      arg = i;
    } else {
      min2 = fminf(min2, m);
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float s = (x[i] < 0.0f) ? -tsign : tsign;
    x[i] = (s * ((i == arg) ? min2 : min1)) * alpha;
  }
}

// Route "wide": check_update over the slots of a check wider than the
// register instances, in two passes whose state does not grow with the slot
// count.  Pass 1 folds each slot's incoming message, in slot order, into the
// sign parity and into either the phi total (sum-product, left to right) or
// min1 / min2 / the first argmin (min-sum); pass 2 forms each slot's outgoing
// message from its incoming one with out(), as check_update stores it.  The
// same operations in the same order as check_update: the same bits.
struct WideCheck {
  float tsign, acc, min2;  // acc: the phi total (ps) or min1 (ms)
  int arg;

  __device__ __forceinline__ void init(float synd_sign) {
    tsign = synd_sign;
    acc = 0.0f;
    min2 = BIG;
    arg = 0;
  }
  __device__ __forceinline__ void fold(int i, float x, int method) {
    if (x < 0.0f) tsign = -tsign;
    const float m = fabsf(x);
    if (method == 0) {
      const float ph = phi_f(m);
      acc = (i == 0) ? ph : acc + ph;
    } else if (i == 0 || m < acc) {
      min2 = (i == 0) ? BIG : acc;
      acc = m;
      arg = i;
    } else {
      min2 = fminf(min2, m);
    }
  }
  __device__ __forceinline__ float out(int i, float x, int method, float alpha) const {
    const float s = (x < 0.0f) ? -tsign : tsign;
    return (method == 0) ? s * phi_f(acc - phi_f(fabsf(x)))
                         : (s * ((i == arg) ? min2 : acc)) * alpha;
  }
};
