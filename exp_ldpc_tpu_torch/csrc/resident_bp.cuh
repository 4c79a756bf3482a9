// Shared device code of the shared-memory-resident whole-decode kernels K2
// (stbp.cu) and K6 (bpflat.cu): the walk of a block's (row, shot) items,
// the threads per block each instance is compiled for, and the device
// limits the Python plan (utils/cuda_build.py::resident_plan) reads.
//
// A resident block owns G consecutive shots.  Every shared-memory array is
// [row][stride] (stride >= G slots per row, shots innermost), so the items
// of one phase, walked with shots innermost, touch consecutive words.
#pragma once

#include <cuda_runtime.h>

// utils/cuda_build.py::resident_max_threads: 64 registers a thread up to 16
// check slots, 128 above.
template <int MAXP>
struct ResidentThreads {
  static constexpr int value = MAXP <= 16 ? 1024 : 512;
};

// Calls f(hi, lo, shot) for the block's items (hi < H, lo < L, shot < G),
// shot innermost, then lo, then hi: thread t takes items t, t + T, t + 2T,
// ... of that order (T = blockDim.x).  The indices advance by addition, so
// no item pays for a division.
template <typename F>
__device__ __forceinline__ void walk(int H, int L, int G, F&& f) {
  if (H <= 0 || L <= 0) return;  // no items (K2's measurement rows at 0 rounds)
  const int T = blockDim.x;
  const int row0 = threadIdx.x / G, drow = T / G;
  int shot = threadIdx.x - row0 * G;
  const int dshot = T - drow * G;
  int hi = row0 / L, lo = row0 - hi * L;
  const int dhi = drow / L, dlo = drow - dhi * L;
  while (hi < H) {
    f(hi, lo, shot);
    shot += dshot;
    lo += dlo;
    hi += dhi;
    if (shot >= G) {
      shot -= G;
      ++lo;
    }
    if (lo >= L) {
      lo -= L;
      ++hi;
    }
  }
}

// out[0]: the opt-in shared memory per block (bytes), out[1]: the SM count.
extern "C" int device_limits(int device, int* out) {
  cudaError_t e = cudaDeviceGetAttribute(&out[0], cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceGetAttribute(&out[1], cudaDevAttrMultiProcessorCount, device);
}

// Opt a kernel in to `bytes` of dynamic shared memory (above the 48 KB
// default), then launch it; returns the first CUDA error.
template <typename K, typename... A>
static int launch_resident(K kernel, int blocks, int threads, int bytes, cudaStream_t stream,
                           A... args) {
  if (bytes > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<blocks, threads, bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}
