// K8: the OSD step of BP+OSD, one block per shot, on two routes: "block"
// (below), the shot's matrix in the block's shared memory, and "device"
// (past one block's shared memory: the section at the end of this file).
//
// Replaces no TPU kernel: the JAX package runs this step on the host, in the
// threaded C++ of native/gf2_kernels.cpp::osd_batch (osd_one_shot), which is
// this kernel's plain version, and which still serves every shape and option
// the kernel does not take (decoders/osd_cuda.py::takes).  Same contract, bit
// for bit:
//   * order: the ordered columns of a shot come from the caller
//     (decoders/osd_cuda.py::reliability_order: numpy's stable ascending
//     argsort of the float64 LLRs, NaN last, -0.0 equal to +0.0);
//   * elimination: [H[:, order] | s] reduced as gf2_row_reduce does: the
//     pivot of column j is the first row >= pr holding it, swapped into row
//     pr, and the column is cleared in every other row; the pivots keep that
//     order;
//   * cost: clamp(x, +-30), q = 1/(1+e^x) clamped to [1e-12, 1-1e-12],
//     log((1-q)/q) floored at 1e-9 with NaN kept, all in float64 (the build
//     has no multiply-add contraction, as the C++ has none to make here);
//   * candidates: the base, then the singles in order, then the pairs
//     i < j < min(order, k) (osd_cs), or all 2^w patterns (osd_e); a
//     candidate costs its set pivot bits summed over the pivot rows in order,
//     then its non-pivot bits; a later candidate wins only where its cost is
//     strictly lower (so a NaN base wins, and a NaN candidate never does);
//   * output: the winner in the original columns.
// CUDA's exp and log may differ from glibc's by an ulp, so two candidates
// whose costs tie to the last bits may be ranked differently; nothing else
// differs.
//
// What bounds it on an H100.  A shot's augmented matrix, r x (n+1) bits, is
// the working set: 540 x 1,558 at HGP-225 x 4 rounds, 105,840 B in 32-bit
// words, read and rewritten once per pivot from the pivot's word on.  The
// elimination is about rank x (rows holding the column) x (words past the
// pivot's) word XORs through shared memory, a few million a shot: the
// shared-memory pipe and the barrier per column bound it, not device memory
// (a shot reads n ordered indices, n LLRs and r syndrome bytes, and writes n
// bytes).
//
// Design.  A block owns one shot and keeps [H[:, order] | s] packed in
// dynamic shared memory, rows of an odd word stride, so that a warp's 32
// rows at one word index fall in 32 banks; at HGP-225 x 4 two blocks share
// an SM.  One thread owns each row (r <= 1,024); rows are never moved: each
// thread holds its row's logical position in a register, and a swap changes
// two positions.  Per column, a warp minimum (__reduce_min_sync) and a block
// minimum over (position, row) find the pivot, the first row at or past pr
// that holds the column; then each other row holding it XORs the pivot row
// into itself from the pivot's word on.  The matrix is built from H's
// columns (CSC, on the card once per decoder) by shared atomics.  Then a
// thread per candidate sums its cost over the pivot rows in order (the rows'
// costs and physical indices in shared memory, broadcast to the warp), and a
// block argmin with the first-index rule picks the winner, which the threads
// of the pivot rows and thread 0 write out.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "resident_bp.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NONE = 0xffffffffu;
constexpr int ROW_BITS = 10;                // decoders/osd_cuda.py::MAX_ROWS = 1 << ROW_BITS
constexpr int MAX_ROWS = 1 << ROW_BITS;
constexpr int MAX_COLS = 65535;             // non-pivot columns held as uint16
constexpr int OSD_E_MAX_ORDER = 10;         // decoders/osd_cuda.py::OSD_E_MAX_ORDER
constexpr int MAX_ORDER = 62;               // osd_batch's own limit

// Byte offsets of a block's dynamic shared memory (decoders/osd_cuda.py::
// smem_bytes): the pivot rows' costs (double, by logical row), the argmin's
// partials (32 doubles, 32 ints), the pivot search's warp minima (2 x 32, one
// set a column in turn), the matrix (r rows of Wp words), the pivot columns'
// mask, each logical row's physical row and syndrome bit (uint16), the
// non-pivot columns in order (uint16).  The device route keeps the matrix
// in device memory: its layout has no `mat` bytes (with_mat false;
// decoders/osd_cuda.py::device_smem_bytes).
struct Layout {
  int words, stride, mask_words;
  int pcost, red_c, red_i, keys, mat, mask, rowinfo, nonpiv, total;
};

__host__ __device__ inline Layout layout(int r, int n, bool with_mat = true) {
  Layout L;
  L.words = (n + 1 + 31) >> 5;
  L.stride = L.words | 1;
  L.mask_words = (n + 31) >> 5;
  L.pcost = 0;
  L.red_c = L.pcost + 8 * r;
  L.red_i = L.red_c + 8 * 32;
  L.keys = L.red_i + 4 * 32;
  L.mat = L.keys + 4 * 64;
  L.mask = L.mat + (with_mat ? 4 * r * L.stride : 0);
  L.rowinfo = L.mask + 4 * L.mask_words;
  L.nonpiv = L.rowinfo + 2 * r;
  L.total = L.nonpiv + 2 * n;
  return L;
}

__device__ __forceinline__ double osd_cost(double x) {
  if (x < -30.0) x = -30.0;
  if (x > 30.0) x = 30.0;
  double q = 1.0 / (1.0 + exp(x));
  if (q < 1e-12) q = 1e-12;
  if (q > 1.0 - 1e-12) q = 1.0 - 1e-12;
  const double c = log((1.0 - q) / q);
  return (c > 1e-9 || isnan(c)) ? c : 1e-9;
}

__device__ __forceinline__ unsigned bit_at(const unsigned* row, int col) {
  return (row[col >> 5] >> (col & 31)) & 1u;
}

// osd_cs candidate c (0 base, 1..k singles, then the pairs i < j < w) as
// non-pivot indices a, b (-1 where unset).
__device__ __forceinline__ void cs_candidate(int c, int k, int w, int& a, int& b) {
  a = b = -1;
  if (c == 0) return;
  if (c <= k) {
    a = c - 1;
    return;
  }
  int q = c - 1 - k, i = 0;
  while (q >= w - 1 - i) {
    q -= w - 1 - i;
    ++i;
  }
  a = i;
  b = i + 1 + q;
}

// [H[:, order] | s] packed into mat (r rows of Wp words, bit j of a row in
// word j / 32) from H's columns, and the pivot mask cleared, by the block.
__device__ __forceinline__ void osd_build(unsigned* mat, unsigned* mask, int mask_words,
                                          const int* colptr, const int* rowidx, const int* ord,
                                          const uint8_t* syn, int r, int n, int Wp) {
  const int T = blockDim.x, tid = threadIdx.x;
  for (int i = tid; i < r * Wp; i += T) mat[i] = 0u;
  for (int i = tid; i < mask_words; i += T) mask[i] = 0u;
  __syncthreads();
  for (int j = tid; j < n; j += T) {
    const int c = ord[j];
    const unsigned bit = 1u << (j & 31);
    for (int e = colptr[c]; e < colptr[c + 1]; ++e) atomicOr(&mat[rowidx[e] * Wp + (j >> 5)], bit);
  }
  for (int p = tid; p < r; p += T)
    if (syn[p] & 1) atomicOr(&mat[p * Wp + (n >> 5)], 1u << (n & 31));
  __syncthreads();
}

// After the elimination, K8's contract on both routes: the pivot rows'
// infos, costs and column mask; the non-pivot columns in order; the
// candidates' costs, a thread each in turn, and the winner, written to o in
// the original columns.  `mat` holds the rows (the block's shared memory on
// the block route, its slot of device memory on the device route); this
// thread's row is `myrow`, row p at logical position L, pivot of column
// mycol; keys[0] and keys[1] take the two flags.
__device__ __forceinline__ void osd_finish(const unsigned* mat, const unsigned* myrow, int Wp,
                                           int n, int mask_words, int rank, bool live, int L,
                                           int p, int mycol, const int* ord, const double* x,
                                           int method, int osd_order, double* pcost,
                                           double* red_c, int* red_i, unsigned* keys,
                                           unsigned* mask, uint16_t* rowinfo, uint16_t* nonpiv,
                                           uint8_t* o) {
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = T >> 5;
  // the pivot rows: physical row and syndrome bit, cost, column mask
  if (live && L < rank) {
    rowinfo[L] = (uint16_t)(p | (bit_at(myrow, n) << 15));
    pcost[L] = osd_cost(x[ord[mycol]]);
    atomicOr(&mask[mycol >> 5], 1u << (mycol & 31));
  }
  __syncthreads();
  // the non-pivot columns in order (warp 0: a scan of the mask's popcounts)
  if (warp == 0) {
    int base = 0;
    for (int w0 = 0; w0 < mask_words; w0 += 32) {
      const int wi = w0 + lane;
      unsigned m = 0u;
      if (wi < mask_words) {
        m = ~mask[wi];
        const int valid = n - 32 * wi;
        if (valid < 32) m &= (1u << valid) - 1u;
      }
      const int cnt = __popc(m);
      int incl = cnt;
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += v;
      }
      int at = base + incl - cnt;
      while (m) {
        nonpiv[at++] = (uint16_t)(32 * wi + __ffs(m) - 1);
        m &= m - 1u;
      }
      base += __shfl_sync(FULL, incl, 31);
    }
  }
  __syncthreads();

  // Candidates, a thread each in turn; the best of a thread keeps the first
  // index on ties, as its candidates come in increasing order.
  const int k = n - rank;
  const int w = min(osd_order, k);
  const int ncand = method == 2 ? 1 + k + w * (w - 1) / 2 : method == 1 ? 1 << w : 1;
  double best = INFINITY;
  int best_i = INT_MAX;
  for (int c = tid; c < ncand; c += T) {
    double cost = 0.0;
    if (method == 1) {  // osd_e: pattern c over the first w non-pivots
      for (int i = 0; i < rank; ++i) {
        const unsigned info = rowinfo[i];
        const unsigned* row = mat + (info & (MAX_ROWS - 1)) * Wp;
        unsigned bit = info >> 15;
        for (unsigned m = (unsigned)c; m; m &= m - 1u) bit ^= bit_at(row, nonpiv[__ffs(m) - 1]);
        if (bit) cost += pcost[i];
      }
      for (unsigned m = (unsigned)c; m; m &= m - 1u) cost += osd_cost(x[ord[nonpiv[__ffs(m) - 1]]]);
    } else {
      int a, b;
      cs_candidate(c, k, w, a, b);
      const int ca = a >= 0 ? nonpiv[a] : -1, cb = b >= 0 ? nonpiv[b] : -1;
      for (int i = 0; i < rank; ++i) {
        const unsigned info = rowinfo[i];
        const unsigned* row = mat + (info & (MAX_ROWS - 1)) * Wp;
        unsigned bit = info >> 15;
        if (ca >= 0) bit ^= bit_at(row, ca);
        if (cb >= 0) bit ^= bit_at(row, cb);
        if (bit) cost += pcost[i];
      }
      if (ca >= 0) cost += osd_cost(x[ord[ca]]);
      if (cb >= 0) cost += osd_cost(x[ord[cb]]);
    }
    if (c == 0) keys[0] = isnan(cost) ? 1u : 0u;  // a NaN base is never displaced
    if (cost < best) {
      best = cost;
      best_i = c;
    }
  }
  for (int d = 16; d; d >>= 1) {
    const double oc = __shfl_down_sync(FULL, best, d);
    const int oi = __shfl_down_sync(FULL, best_i, d);
    if (oc < best || (oc == best && oi < best_i)) {
      best = oc;
      best_i = oi;
    }
  }
  if (lane == 0) {
    red_c[warp] = best;
    red_i[warp] = best_i;
  }
  __syncthreads();
  if (warp == 0) {
    best = lane < nwarps ? red_c[lane] : INFINITY;
    best_i = lane < nwarps ? red_i[lane] : INT_MAX;
    for (int d = 16; d; d >>= 1) {
      const double oc = __shfl_down_sync(FULL, best, d);
      const int oi = __shfl_down_sync(FULL, best_i, d);
      if (oc < best || (oc == best && oi < best_i)) {
        best = oc;
        best_i = oi;
      }
    }
    if (lane == 0) keys[1] = keys[0] ? 0u : (unsigned)best_i;
  }
  for (int j = tid; j < n; j += T) o[j] = 0;
  __syncthreads();

  // The winner in the original columns.
  const int win = (int)keys[1];
  if (method == 1) {
    if (live && L < rank) {
      unsigned bit = bit_at(myrow, n);
      for (unsigned m = (unsigned)win; m; m &= m - 1u) bit ^= bit_at(myrow, nonpiv[__ffs(m) - 1]);
      if (bit) o[ord[mycol]] = 1;
    }
    if (tid == 0)
      for (unsigned m = (unsigned)win; m; m &= m - 1u) o[ord[nonpiv[__ffs(m) - 1]]] = 1;
  } else {
    int a, b;
    cs_candidate(win, k, w, a, b);
    const int ca = a >= 0 ? nonpiv[a] : -1, cb = b >= 0 ? nonpiv[b] : -1;
    if (live && L < rank) {
      unsigned bit = bit_at(myrow, n);
      if (ca >= 0) bit ^= bit_at(myrow, ca);
      if (cb >= 0) bit ^= bit_at(myrow, cb);
      if (bit) o[ord[mycol]] = 1;
    }
    if (tid == 0) {
      if (ca >= 0) o[ord[ca]] = 1;
      if (cb >= 0) o[ord[cb]] = 1;
    }
  }
}

}  // namespace

// Outside the anonymous namespace, so that a device trace names it.
__global__ void __launch_bounds__(1024, 1)
osd_kernel(const int* __restrict__ colptr, const int* __restrict__ rowidx,
           const int* __restrict__ order, const double* __restrict__ llr,
           const uint8_t* __restrict__ synd, int r, int n, int method, int osd_order,
           uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(r, n);
  double* pcost = (double*)(smem + lay.pcost);
  double* red_c = (double*)(smem + lay.red_c);
  int* red_i = (int*)(smem + lay.red_i);
  unsigned* keys = (unsigned*)(smem + lay.keys);
  unsigned* mat = (unsigned*)(smem + lay.mat);
  unsigned* mask = (unsigned*)(smem + lay.mask);
  uint16_t* rowinfo = (uint16_t*)(smem + lay.rowinfo);
  uint16_t* nonpiv = (uint16_t*)(smem + lay.nonpiv);
  const int W = lay.words, Wp = lay.stride;

  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = T >> 5;
  const size_t s = blockIdx.x;
  const int* ord = order + s * n;
  const double* x = llr + s * n;
  uint8_t* o = out + s * n;

  osd_build(mat, mask, lay.mask_words, colptr, rowidx, ord, synd + s * r, r, n, Wp);

  // Elimination: this thread's row p, at logical position L.
  const int p = tid;
  const bool live = p < r;
  unsigned* myrow = mat + (live ? p : 0) * Wp;
  int L = live ? p : MAX_ROWS, mycol = -1, pr = 0, buf = 0;
  for (int col = 0; col < n && pr < r; ++col) {
    const int wc = col >> 5;
    const bool has = live && ((myrow[wc] >> (col & 31)) & 1u);
    unsigned key = (has && L >= pr) ? ((unsigned)L << ROW_BITS | (unsigned)p) : NONE;
    key = __reduce_min_sync(FULL, key);
    if (lane == 0) keys[buf * 32 + warp] = key;
    __syncthreads();
    key = __reduce_min_sync(FULL, lane < nwarps ? keys[buf * 32 + lane] : NONE);
    buf ^= 1;
    if (key == NONE) continue;  // no row at or past pr holds the column
    const int src = (int)(key >> ROW_BITS), P = (int)(key & (MAX_ROWS - 1));
    if (p == P) {
      L = pr;
      mycol = col;
    } else if (L == pr) {
      L = src;
    }
    if (has && p != P) {
      const unsigned* prow = mat + P * Wp;
      for (int k = wc; k < W; ++k) myrow[k] ^= prow[k];
    }
    ++pr;
    __syncthreads();
  }
  const int rank = pr;

  osd_finish(mat, myrow, Wp, n, lay.mask_words, rank, live, L, p, mycol, ord, x, method,
             osd_order, pcost, red_c, red_i, keys, mask, rowinfo, nonpiv, o);
}

// S shots: colptr (n+1) and rowidx (nnz) int32, H's columns (entries mod 2);
// order (S, n) int32, each row a permutation of 0..n-1; llr (S, n) float64 in
// the original columns; synd (S, r) uint8 (bit 0 read); out (S, n) uint8.
// method 0 osd0, 1 osd_e, 2 osd_cs.  threads and smem_bytes are the
// caller's plan (decoders/osd_cuda.py): a mismatch is refused.
extern "C" int osd_solve(const void* colptr, const void* rowidx, const void* order,
                         const void* llr, const void* synd, int S, int r, int n, int method,
                         int osd_order, int threads, int smem_bytes, void* out, void* stream) {
  if (S < 1 || r < 1 || r > MAX_ROWS || n < 1 || n > MAX_COLS || method < 0 || method > 2 ||
      osd_order < 0 || osd_order > MAX_ORDER || (method == 1 && osd_order > OSD_E_MAX_ORDER))
    return (int)cudaErrorInvalidValue;
  if (threads != 32 * ((r + 31) / 32) || smem_bytes != layout(r, n).total)
    return (int)cudaErrorInvalidValue;
  // all of the SM's unified memory as shared memory, so that two blocks of
  // the largest shapes fit beside each other
  cudaError_t e = cudaFuncSetAttribute(osd_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                       (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  return launch_resident(osd_kernel, S, threads, smem_bytes, (cudaStream_t)stream,
                         (const int*)colptr, (const int*)rowidx, (const int*)order,
                         (const double*)llr, (const uint8_t*)synd, r, n, method, osd_order,
                         (uint8_t*)out);
}

// ---------------------------------------------------------------------------
// The device route: K8 past one block's shared memory.
//
// Where a shot's packed [H[:, order] | s] does not fit one block's opt-in
// shared memory (936 x 2,737 bits at the gross code over 12 rounds: 325,728 B
// in 87-word rows, against the H100's 232,448 B), the matrix lives in device
// memory: each block owns a slot of r x Wp words of a scratch buffer and
// takes shots blockIdx.x, + gridDim.x, ... in turn, so that the slots in
// use, one a block in flight (one block an SM: 43 MB at the gross shape),
// stay in the 50 MB L2.  The algorithm, every rounding and the candidates'
// order of additions are K8's; the per-row state (costs, pivot infos, mask,
// non-pivot list) stays in shared memory.  Since each word of the matrix is
// now an L2 access, the elimination's XOR is a warp's work: a warp XORs the
// pivot row into each of its rows that hold the column, its lanes on 32
// consecutive words, the pivot row's words read once for the warp's rows,
// so that a column's XOR costs about one L2 round trip; each thread keeps
// its row's word of the current column in a register.
//
// Tried first, and measured 2x slower (PERF.md): a thread-block cluster of
// two CTAs a shot, the rows split over the CTAs' distributed shared memory.
// Its cluster barrier a column cost as much as this route's block barrier
// and L2 round trip, with half as many shots in flight (two SMs a shot).
// What bounds it: a block barrier a column and an L2 round trip a pivot
// column, 2,736 and 930 a shot at the gross shape; and the candidates' reads
// of the pivot rows, through L2.
// ---------------------------------------------------------------------------

namespace {

// The warp's rows in `todo` (bit j: lane j's row, at rows + j Wp) ^= prow
// from word wc on: the lanes take words wc + lane, + 32, ..., 128 words of
// the pivot row in flight, read once for all the warp's rows.  Returns
// prow[wc] to every lane.
__device__ __forceinline__ unsigned warp_xor(unsigned* rows, unsigned todo, const unsigned* prow,
                                             int wc, int W, int Wp, int lane) {
  unsigned first = 0u;
  for (int k0 = wc; k0 < W; k0 += 4 * 32) {
    unsigned v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + 32 * u + lane;
      v[u] = k < W ? prow[k] : 0u;
    }
    if (k0 == wc) first = __shfl_sync(FULL, v[0], 0);
    for (unsigned m = todo; m; m &= m - 1u) {
      unsigned* row = rows + (__ffs(m) - 1) * Wp;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = k0 + 32 * u + lane;
        if (k < W) row[k] ^= v[u];
      }
    }
  }
  __syncwarp();
  return first;
}

}  // namespace

__global__ void __launch_bounds__(1024, 1)
osd_device_kernel(const int* __restrict__ colptr, const int* __restrict__ rowidx,
                  const int* __restrict__ order, const double* __restrict__ llr,
                  const uint8_t* __restrict__ synd, int S, int r, int n, int method,
                  int osd_order, unsigned* __restrict__ scratch, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(r, n, false);
  double* pcost = (double*)(smem + lay.pcost);
  double* red_c = (double*)(smem + lay.red_c);
  int* red_i = (int*)(smem + lay.red_i);
  unsigned* keys = (unsigned*)(smem + lay.keys);
  unsigned* mask = (unsigned*)(smem + lay.mask);
  uint16_t* rowinfo = (uint16_t*)(smem + lay.rowinfo);
  uint16_t* nonpiv = (uint16_t*)(smem + lay.nonpiv);
  const int W = lay.words, Wp = lay.stride;
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = T >> 5;
  unsigned* mat = scratch + (size_t)blockIdx.x * r * Wp;  // this block's slot

  for (size_t s = blockIdx.x; s < (size_t)S; s += gridDim.x) {
    const int* ord = order + s * n;
    const double* x = llr + s * n;
    uint8_t* o = out + s * n;

    osd_build(mat, mask, lay.mask_words, colptr, rowidx, ord, synd + s * r, r, n, Wp);

    // Elimination, as K8's: this thread's row p at logical position L; its
    // word of the column in `cur`.
    const int p = tid;
    const bool live = p < r;
    unsigned* myrow = mat + (live ? p : 0) * Wp;
    int L = live ? p : MAX_ROWS, mycol = -1, pr = 0, buf = 0;
    unsigned cur = 0u;
    for (int col = 0; col < n && pr < r; ++col) {
      const int wc = col >> 5;
      if ((col & 31) == 0) cur = myrow[wc];
      const bool has = live && ((cur >> (col & 31)) & 1u);
      unsigned key = (has && L >= pr) ? ((unsigned)L << ROW_BITS | (unsigned)p) : NONE;
      key = __reduce_min_sync(FULL, key);
      if (lane == 0) keys[buf * 32 + warp] = key;
      __syncthreads();
      key = __reduce_min_sync(FULL, lane < nwarps ? keys[buf * 32 + lane] : NONE);
      buf ^= 1;
      if (key == NONE) continue;  // no row at or past pr holds the column
      const int src = (int)(key >> ROW_BITS), P = (int)(key & (MAX_ROWS - 1));
      if (p == P) {
        L = pr;
        mycol = col;
      } else if (L == pr) {
        L = src;
      }
      // each warp XORs the pivot row into its rows that hold the column
      const unsigned todo = __ballot_sync(FULL, has && p != P);
      if (todo) {
        const unsigned pw = warp_xor(mat + warp * 32 * Wp, todo, mat + P * Wp, wc, W, Wp, lane);
        if (has && p != P) cur ^= pw;
      }
      ++pr;
    }
    const int rank = pr;

    osd_finish(mat, myrow, Wp, n, lay.mask_words, rank, live, L, p, mycol, ord, x, method,
               osd_order, pcost, red_c, red_i, keys, mask, rowinfo, nonpiv, o);
    __syncthreads();  // the next shot reuses the slot and the shared memory
  }
}

// osd_solve's arguments and contract, on the device route: `blocks` blocks
// of `threads` threads and `smem_bytes` of shared memory, each with the
// matrix in its slot of scratch (blocks x r x stride words), taking the
// shots in turn (decoders/osd_cuda.py::device_plan); a mismatch is refused.
extern "C" int osd_device_solve(const void* colptr, const void* rowidx, const void* order,
                                const void* llr, const void* synd, int S, int r, int n,
                                int method, int osd_order, int blocks, int threads,
                                int smem_bytes, void* scratch, void* out, void* stream) {
  if (S < 1 || r < 1 || r > MAX_ROWS || n < 1 || n > MAX_COLS || method < 0 || method > 2 ||
      osd_order < 0 || osd_order > MAX_ORDER || (method == 1 && osd_order > OSD_E_MAX_ORDER) ||
      blocks < 1 || blocks > S || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  if (threads != 32 * ((r + 31) / 32) || smem_bytes != layout(r, n, false).total)
    return (int)cudaErrorInvalidValue;
  return launch_resident(osd_device_kernel, blocks, threads, smem_bytes, (cudaStream_t)stream,
                         (const int*)colptr, (const int*)rowidx, (const int*)order,
                         (const double*)llr, (const uint8_t*)synd, S, r, n, method, osd_order,
                         (unsigned*)scratch, (uint8_t*)out);
}
