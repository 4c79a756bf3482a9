// K9: the Pauli-frame sampler of a whole batch in one launch, one thread a
// shot, walking the circuit's op table (sampler/device.py::op_table) in
// order: prologue, the body `repeat` times, epilogue.
//
// Replaces no TPU kernel: the JAX package samples with XLA
// (exp_ldpc_tpu/sampler/device.py, no Pallas kernel).  The port's plain
// version, sampler/device.py::_apply, runs 3-15 PyTorch calls an op and
// replays the REPEAT body from Python: some 720 launches a batch at HGP-225
// x 4 rounds and 2,000 at the gross code x 12, each far shorter than its
// launch, so the host's launch rate and not the card set its pace.  This
// kernel is that loop on the card.  Its semantics are the plain version's
// (sampler/reference.py states the frame algebra), its random bits are its
// own: the same distribution, other bits.
//
// What bounds it on an H100.  The record is written once, M bytes a shot
// (37 MB at the gross code's 20,000 shots), and every noise channel draws
// from the shot's Philox4x32-10 streams (utils/bounds.py::sampler_bound
// counts their integer operations).  Neither is near: a batch has only a
// few warps an SM (16,384 or 20,000 shots, one warp a scheduler), and a
// shot's work is serial, so the latency of the chain of instructions a
// thread runs sets the time.  Measured on the card: a read-modify-write of
// a frame word waits for the last one to the same word (consecutive qubits
// share a word), and branches around each target keep the compiler from
// overlapping independent targets; either way ~200 cycles a target.
//
// Design.
//   * Op table: rows of OP_FIELDS int32 (the Field enum below); the REPEAT
//     loop runs here, so a round count costs no launch.  The noise values
//     are read at run time from `args`, so a rebind rebuilds nothing.
//   * Frames: a shot's X and Z bits, packed 32 qubits a word.  Route
//     "shared": in dynamic shared memory, word w of thread t at w * T + t
//     (T threads a block), so a warp, whose lanes touch the same word of
//     their own shots, hits 32 banks.  Route "device", where one warp's
//     frames do not fit a block's shared memory: the same code on words of
//     device memory laid (word, shot), so a warp's accesses coalesce.  Ops
//     never cross shots: no barrier anywhere.
//   * Chunks: the host (sampler/device.py::op_table) cuts each reset,
//     measurement and single-qubit channel into chunks of up to CH
//     consecutive targets in one frame word, and each CX or CZ into passes
//     of edges (source bit -> destination bit: CX's X_a -> X_b and Z_b ->
//     Z_a, CZ's X_b -> Z_a and X_a -> Z_b) cut into chunks of up to CH edges
//     with one destination word.  A chunk keeps its word in registers (a
//     Slot), loaded when the word changes and written back when it changes
//     again or the op ends, and runs its targets branch-free (a mask marks
//     the real ones, no qubit is in a chunk twice), their bits merged by
//     trees of XORs, so the compiler overlaps them.  Chunks go in the
//     circuit's order, so an op that repeats a qubit is exact; a pass's
//     edges are sorted by destination word where they commute (CZ always,
//     CX where no qubit repeats: no edge then writes a bit another reads),
//     else they keep the circuit's order, one a chunk.
//   * Randomness: Philox4x32-10 keyed by the generator's seed, counter
//     (call, shot, stream) (curand's subsequence `shot` at offset 4 * call,
//     stream 0).  Stream 0 gives the noise words, stream 1 the random frame
//     bits of resets and measurements; both are addressed by call, each
//     op's from its first call within the block on (F_CALL, F_BCALL): a
//     chunk takes whole calls, so its calls are independent of the others
//     and run side by side.  Every shot draws the same words at the same
//     places; the wrapper advances the generator past the longer stream.
//     A Bernoulli(p) is a word below ceil(p * 2^32); a uniform of {1..k} is
//     1 + floor(word * k / 2^32).  DEPOLARIZE1 makes its Pauli calls only
//     where a chunk has an error; a chunk's 8 random frame bits are a byte
//     of stream 1, 16 chunks to a call.
//   * Record: every byte of the (M, S) uint8 record is written, M rows of
//     S shots, so a warp writes 32 consecutive bytes.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "resident_bp.cuh"

namespace {

// sampler/device.py::OPCODES
enum Opcode : int {
  OP_RZ = 0, OP_RX, OP_MZ, OP_MX, OP_MRZ, OP_MRX, OP_CX, OP_CZ, OP_DEP1, OP_DEP2,
  OP_XERR, OP_YERR, OP_ZERR, OP_PC1, OP_PC2, OP_CORR, OP_ELSE
};
// A row of the op table (sampler/device.py::OpTable): opcode, targets,
// their offset in `data`, first noise slot, first measurement within the
// block, noise slots, the offset of the op's chunks (E / ELSE: its Pauli
// codes), its chunks (CX: the X pass's), CX's Z pass's chunks, the op's
// first call on streams 0 and 1 within the block, a pad.
enum Field : int {
  F_CODE = 0, F_N, F_OFF, F_ARG, F_MEAS, F_NARGS, F_EXTRA, F_NCH, F_NCH2, F_CALL, F_BCALL,
  OP_FIELDS = 12
};

constexpr int MAX_THREADS = 64;   // sampler/device.py::K9_THREADS
constexpr int CH = 8;             // sampler/device.py::CHUNK: targets (or edges) a chunk

// Philox4x32-10 of counter (call, shot, stream) under key (k0, k1).
__device__ __forceinline__ uint4 philox(uint64_t call, uint32_t shot, uint32_t stream,
                                        uint32_t k0, uint32_t k1) {
  uint32_t c0 = (uint32_t)call, c1 = (uint32_t)(call >> 32), c2 = shot, c3 = stream;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// A shot's two streams (the design note above).
struct Rng {
  uint32_t k0, k1, shot;
  uint64_t call0;

  __device__ __forceinline__ uint4 words(uint64_t call) const {
    return philox(call0 + call, shot, 0, k0, k1);
  }
  __device__ __forceinline__ uint4 bits(uint64_t call) const {
    return philox(call0 + call, shot, 1, k0, k1);
  }
};

// The event u < p * 2^32 for a 32-bit word u, as u < this (0 for p <= 0 or
// NaN, 2^32 for p >= 1).  p * 2^32 is exact in double.
__device__ __forceinline__ uint64_t threshold(float p) {
  const double t = (double)p * 4294967296.0;
  if (!(t > 0.0)) return 0;
  if (t >= 4294967296.0) return 4294967296ull;
  return (uint64_t)ceil(t);
}

__device__ __forceinline__ uint32_t below(uint32_t u, uint64_t thr) {
  return (uint64_t)u < thr ? 1u : 0u;
}

// 1 + floor(u * k / 2^32): a uniform of {1..k}.
__device__ __forceinline__ uint32_t uniform_1_to(uint32_t u, uint32_t k) {
  return 1u + __umulhi(u, k);
}

__device__ __forceinline__ uint32_t pick(const uint4& r, int k) {
  return k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w;
}

// Word j of the 8 in two calls' words.
__device__ __forceinline__ uint32_t pick8(const uint4& r0, const uint4& r1, int j) {
  return pick(j < 4 ? r0 : r1, j & 3);
}

// One shot's frames: word w of plane p (0 X, 1 Z) at base[(p nw + w) stride].
struct Frames {
  uint32_t* base;
  size_t stride;
  int nw;

  __device__ __forceinline__ uint32_t* word(int plane, int w) const {
    return base + (size_t)(plane * nw + w) * stride;
  }
  __device__ __forceinline__ uint32_t* x(int q) const { return word(0, q >> 5); }
  __device__ __forceinline__ uint32_t* z(int q) const { return word(1, q >> 5); }
};

// Word w of both planes in registers (w < 0: none).
struct Slot {
  int w;
  uint32_t x, z;

  __device__ __forceinline__ void flush(const Frames& f) const {
    if (w >= 0) {
      *f.word(0, w) = x;
      *f.word(1, w) = z;
    }
  }
  __device__ __forceinline__ void hold(const Frames& f, int word) {
    if (word != w) {
      flush(f);
      w = word;
      x = *f.word(0, w);
      z = *f.word(1, w);
    }
  }
};

// A chunk of a single-qubit op (sampler/device.py::_single_chunks): its
// word, the mask of real targets, their bit positions (a byte each), the
// index of its first target in the op.
struct Chunk {
  int w, i0;
  uint32_t mask, lo, hi;

  __device__ __forceinline__ explicit Chunk(const int* c) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(c));
    w = v.x & 0xffffff;
    mask = (uint32_t)v.x >> 24;
    lo = (uint32_t)v.y;
    hi = (uint32_t)v.z;
    i0 = v.w;
  }
  __device__ __forceinline__ int bit(int j) const {
    return ((j < 4 ? lo : hi) >> (8 * (j & 3))) & 31;
  }
  __device__ __forceinline__ uint32_t real(int j) const { return (mask >> j) & 1u; }
  // The word mask of the targets whose bit of `t` (bit j for target j) is
  // set: a tree of XORs (the host puts no qubit twice in a chunk).
  __device__ __forceinline__ uint32_t spread(uint32_t t) const {
    uint32_t m[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) m[j] = ((t >> j) & 1u) << bit(j);
    return ((m[0] ^ m[1]) ^ (m[2] ^ m[3])) ^ ((m[4] ^ m[5]) ^ (m[6] ^ m[7]));
  }
};

// A reset (ZB: RZ, X <- 0 and Z <- a random bit; else RX) or measurement
// (MEASURE: the bit read, flipped by the noise word where `noisy`, is the
// record; RESET clears it after; the other plane's bit is made random) of
// one op, a chunk at a time.  Chunk c's random bits are byte c % 4 of word
// (c / 4) % 4 of stream 1's call `bcall` + c / 16.
template <bool ZB, bool MEASURE, bool RESET>
__device__ __forceinline__ void reset_measure(const Frames& f, Slot& s, const int* chunks,
                                              int nch, const Rng& rng, uint64_t call,
                                              uint64_t bcall, bool noisy, uint64_t thr,
                                              uint8_t* rec, int S) {
  uint4 gw = make_uint4(0, 0, 0, 0);
#pragma unroll 2
  for (int c = 0; c < nch; ++c) {
    const Chunk k(chunks + 4 * c);
    s.hold(f, k.w);
    if ((c & 15) == 0) gw = rng.bits(bcall + (c >> 4));
    const uint32_t g = (pick(gw, (c >> 2) & 3) >> (8 * (c & 3))) & k.mask;
    uint32_t& read = ZB ? s.x : s.z;
    uint32_t& other = ZB ? s.z : s.x;
    if (MEASURE) {
      uint4 e0 = make_uint4(0, 0, 0, 0), e1 = e0;
      if (noisy) {
        e0 = rng.words(call + 2 * c);
        e1 = rng.words(call + 2 * c + 1);
      }
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const uint32_t e = noisy ? below(pick8(e0, e1, j), thr) : 0u;
        if (k.real(j)) rec[(size_t)(k.i0 + j) * S] = (uint8_t)(((read >> k.bit(j)) & 1u) ^ e);
      }
    }
    const uint32_t all = k.spread(k.mask);
    if (RESET || !MEASURE) read &= ~all;
    other = (other & ~all) | k.spread(g);
  }
}

// A pass of edge chunks (sampler/device.py::_edge_chunks): the destination
// bit of plane `dp` ^= the source bit of plane `sp`.  The chunk's source
// words are read together, after its destination word is held.
__device__ __forceinline__ void transfer(const Frames& f, const int* chunks, int nch, int sp,
                                         int dp) {
  int w = -1;
  uint32_t v = 0;
#pragma unroll 2
  for (int c = 0; c < nch; ++c) {
    const int4* p = reinterpret_cast<const int4*>(chunks + 12 * c);
    const int4 h = __ldg(p), s0 = __ldg(p + 1), s1 = __ldg(p + 2);
    const int src[CH] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const uint32_t mask = (uint32_t)h.x >> 24;
    const int dw = h.x & 0xffffff;
    if (dw != w) {
      if (w >= 0) *f.word(dp, w) = v;
      w = dw;
      v = *f.word(dp, w);
    }
    uint32_t sv[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) sv[j] = *f.word(sp, src[j] >> 5);
    // a chunk of one edge (the passes whose edges do not commute) reads its
    // source through the slot; in a longer chunk no edge writes a bit
    // another reads, so memory's copy of the held word serves
    if (sp == dp && (src[0] >> 5) == w) sv[0] = v;
    uint32_t m[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int db = (((uint32_t)(j < 4 ? h.y : h.z)) >> (8 * (j & 3))) & 31;
      m[j] = ((sv[j] >> (src[j] & 31)) & (mask >> j) & 1u) << db;
    }
    v ^= ((m[0] ^ m[1]) ^ (m[2] ^ m[3])) ^ ((m[4] ^ m[5]) ^ (m[6] ^ m[7]));
  }
  if (w >= 0) *f.word(dp, w) = v;
}

// Runs `count` ops of the table from `ops` for one shot; measurement m of
// the block goes to record row `rec_base` + m, an op's calls start at
// `call_base` (stream 0) and `bcall_base` (stream 1) + its F_CALL, F_BCALL.
// The E / ELSE chain starts anew with each block, as in the plain version.
__device__ __forceinline__ void run_block(const int* __restrict__ ops, int count,
                                          const int* __restrict__ data,
                                          const float* __restrict__ args, const Frames& f,
                                          const Rng& rng, uint8_t* __restrict__ record,
                                          int rec_base, uint64_t call_base, uint64_t bcall_base,
                                          int S, int shot) {
  uint32_t chain = 0;
  for (int o = 0; o < count; ++o) {
    const int4* row = reinterpret_cast<const int4*>(ops + o * OP_FIELDS);
    const int4 h0 = __ldg(row), h1 = __ldg(row + 1), h2 = __ldg(row + 2);
    const int code = h0.x, n = h0.y, arg = h0.w, nch = h1.w;
    const int* t = data + h0.z;
    const int* extra = data + h1.z;
    const bool noisy = h1.y > 0;
    const uint64_t call = call_base + (uint32_t)h2.y, bcall = bcall_base + (uint32_t)h2.z;
    // a measurement's first record byte (F_MEAS is -1 for other ops)
    uint8_t* rec = h1.x >= 0 ? record + (size_t)(rec_base + h1.x) * S + shot : record;
    const uint64_t thr = noisy && code != OP_PC1 && code != OP_PC2
                             ? threshold(__ldg(args + arg)) : 0;
    Slot s{-1, 0u, 0u};
    switch (code) {
      case OP_RZ:
        reset_measure<true, false, false>(f, s, extra, nch, rng, call, bcall, false, 0, rec, S);
        break;
      case OP_RX:
        reset_measure<false, false, false>(f, s, extra, nch, rng, call, bcall, false, 0, rec, S);
        break;
      case OP_MZ:
        reset_measure<true, true, false>(f, s, extra, nch, rng, call, bcall, noisy, thr, rec, S);
        break;
      case OP_MX:
        reset_measure<false, true, false>(f, s, extra, nch, rng, call, bcall, noisy, thr, rec,
                                          S);
        break;
      case OP_MRZ:
        reset_measure<true, true, true>(f, s, extra, nch, rng, call, bcall, noisy, thr, rec, S);
        break;
      case OP_MRX:
        reset_measure<false, true, true>(f, s, extra, nch, rng, call, bcall, noisy, thr, rec, S);
        break;
      case OP_CX:
        // X_a -> X_b, then Z_b -> Z_a: the planes never meet
        transfer(f, extra, nch, 0, 0);
        transfer(f, extra + 12 * nch, h2.x, 1, 1);
        break;
      case OP_CZ:
        transfer(f, extra, nch, 0, 1);
        break;
      case OP_DEP1:
#pragma unroll 2
        for (int c = 0; c < nch; ++c) {
          const Chunk k(extra + 4 * c);
          const uint4 e0 = rng.words(call + 4 * c), e1 = rng.words(call + 4 * c + 1);
          uint32_t hit = 0;
#pragma unroll
          for (int j = 0; j < CH; ++j) hit |= below(pick8(e0, e1, j), thr) << j;
          hit &= k.mask;
          if (hit) {
            // the errors' Paulis, each uniform of X, Y, Z (1, 2, 3)
            uint4 p0 = make_uint4(0, 0, 0, 0), p1 = p0;
            if (hit & 0x0f) p0 = rng.words(call + 4 * c + 2);
            if (hit & 0xf0) p1 = rng.words(call + 4 * c + 3);
            uint32_t px = 0, pz = 0;
#pragma unroll
            for (int j = 0; j < CH; ++j) {
              const uint32_t p = uniform_1_to(pick8(p0, p1, j), 3);
              px |= (p & 1u) << j;
              pz |= ((p >> 1) & 1u) << j;
            }
            s.hold(f, k.w);
            s.x ^= k.spread(px & hit);
            s.z ^= k.spread(pz & hit);
          }
        }
        break;
      case OP_XERR:
      case OP_YERR:
      case OP_ZERR: {
        const uint32_t mx = code != OP_ZERR ? 0xffu : 0u, mz = code != OP_XERR ? 0xffu : 0u;
#pragma unroll 2
        for (int c = 0; c < nch; ++c) {
          const Chunk k(extra + 4 * c);
          const uint4 e0 = rng.words(call + 2 * c), e1 = rng.words(call + 2 * c + 1);
          uint32_t e = 0;
#pragma unroll
          for (int j = 0; j < CH; ++j) e |= below(pick8(e0, e1, j), thr) << j;
          e &= k.mask;
          s.hold(f, k.w);
          s.x ^= k.spread(e & mx);
          s.z ^= k.spread(e & mz);
        }
        break;
      }
      case OP_PC1: {
        // the plain version's float32 sums: X or Y below px + py, Y or Z in
        // [px, px + py + pz)
        const float px = __ldg(args + arg), pxy = __fadd_rn(px, __ldg(args + arg + 1));
        const uint64_t t1 = threshold(px), t2 = threshold(pxy),
                       t3 = threshold(__fadd_rn(pxy, __ldg(args + arg + 2)));
#pragma unroll 2
        for (int c = 0; c < nch; ++c) {
          const Chunk k(extra + 4 * c);
          const uint4 e0 = rng.words(call + 2 * c), e1 = rng.words(call + 2 * c + 1);
          uint32_t ex = 0, ez = 0;
#pragma unroll
          for (int j = 0; j < CH; ++j) {
            const uint32_t u = pick8(e0, e1, j);
            ex |= below(u, t2) << j;
            ez |= ((1u - below(u, t1)) & below(u, t3)) << j;
          }
          s.hold(f, k.w);
          s.x ^= k.spread(ex & k.mask);
          s.z ^= k.spread(ez & k.mask);
        }
        break;
      }
      case OP_DEP2:
        // the two-qubit channels and E / ELSE (off the storage circuits'
        // path) update the frames in memory, target by target; pair i / 2
        // takes words i % 4 and i % 4 + 1 of call i / 4
        for (int i = 0; i < n; i += 2) {
          const int a = __ldg(t + i), b = __ldg(t + i + 1);
          const uint4 r = rng.words(call + i / 4);
          const uint32_t p = uniform_1_to(pick(r, (i & 3) + 1), 15) * below(pick(r, i & 3), thr);
          *f.x(a) ^= (p & 1u) << (a & 31);
          *f.z(a) ^= ((p >> 1) & 1u) << (a & 31);
          *f.x(b) ^= ((p >> 2) & 1u) << (b & 31);
          *f.z(b) ^= ((p >> 3) & 1u) << (b & 31);
        }
        break;
      case OP_PC2: {
        // region 1 + #{k : u >= cum_k} over the float32 running sums of the
        // 15 probabilities (IX, IY, ..., ZZ); 16 is no error.  Pair i / 2
        // takes word (i / 2) % 4 of call i / 8.
        uint64_t cum_thr[15];
        float cum = 0.0f;
#pragma unroll
        for (int k = 0; k < 15; ++k) {
          cum = __fadd_rn(cum, __ldg(args + arg + k));
          cum_thr[k] = threshold(cum);
        }
        for (int i = 0; i < n; i += 2) {
          const int a = __ldg(t + i), b = __ldg(t + i + 1);
          const uint32_t u = pick(rng.words(call + i / 8), (i / 2) & 3);
          uint32_t region = 1;
#pragma unroll
          for (int k = 0; k < 15; ++k) region += 1u - below(u, cum_thr[k]);
          const uint32_t hit = region <= 15, pa = region >> 2, pb = region & 3u;
          *f.x(a) ^= (hit & (pa == 1 || pa == 2)) << (a & 31);
          *f.z(a) ^= (hit & (pa == 2 || pa == 3)) << (a & 31);
          *f.x(b) ^= (hit & (pb == 1 || pb == 2)) << (b & 31);
          *f.z(b) ^= (hit & (pb == 2 || pb == 3)) << (b & 31);
        }
        break;
      }
      case OP_CORR:
      case OP_ELSE: {
        const uint32_t fire = below(rng.words(call).x, thr);
        const uint32_t fired = code == OP_CORR ? fire : fire & (1u - chain);
        chain = code == OP_CORR ? fired : chain | fired;
        for (int i = 0; i < n; ++i) {
          const int qi = __ldg(t + i), p = __ldg(extra + i);   // 1 X, 2 Y, 3 Z
          *f.x(qi) ^= (fired & (p == 1 || p == 2)) << (qi & 31);
          *f.z(qi) ^= (fired & (p == 2 || p == 3)) << (qi & 31);
        }
        break;
      }
      default:
        break;   // the wrapper refuses unknown opcodes before the launch
    }
    s.flush(f);
  }
}

}  // namespace

// The kernel, outside the unnamed namespace so that a trace names it
// k9_sample_kernel.  SHARED: the frames in dynamic shared memory (route
// "shared"), else in `frames`, (2 nw, gridDim.x * blockDim.x) words (route
// "device").  Block 0 is the prologue, 1..repeat the body, repeat + 1 the
// epilogue.
template <bool SHARED>
__global__ void __launch_bounds__(MAX_THREADS) k9_sample_kernel(
    const int* __restrict__ ops, const int* __restrict__ data, const float* __restrict__ args,
    int n_pro, int n_body, int n_epi, int repeat, int pro_meas, int body_meas, int pro_calls,
    int body_calls, int pro_bcalls, int body_bcalls, int nw, int S, uint64_t seed,
    uint64_t call0, uint32_t* frames, uint8_t* __restrict__ record) {
  extern __shared__ uint32_t smem[];
  const int shot = blockIdx.x * blockDim.x + threadIdx.x;
  if (shot >= S) return;
  Frames f;
  f.nw = nw;
  if (SHARED) {
    f.base = smem + threadIdx.x;
    f.stride = blockDim.x;
  } else {
    f.base = frames + shot;
    f.stride = (size_t)gridDim.x * blockDim.x;
  }
  for (int w = 0; w < 2 * nw; ++w) f.base[(size_t)w * f.stride] = 0u;
  Rng rng;
  rng.k0 = (uint32_t)seed;
  rng.k1 = (uint32_t)(seed >> 32);
  rng.shot = (uint32_t)shot;
  rng.call0 = call0;
  // one call site, so that run_block is inlined once and its frame accesses
  // are shared-memory (or global) ones
  const int* body = ops + (size_t)n_pro * OP_FIELDS;
  for (int b = 0; b < repeat + 2; ++b) {
    const bool pro = b == 0, epi = b == repeat + 1;
    const uint64_t it = pro ? 0 : (uint64_t)(b - 1);
    run_block(pro ? ops : epi ? body + (size_t)n_body * OP_FIELDS : body,
              pro ? n_pro : epi ? n_epi : n_body, data, args, f, rng, record,
              pro ? 0 : pro_meas + (b - 1) * body_meas,
              pro ? 0 : (uint64_t)pro_calls + it * body_calls,
              pro ? 0 : (uint64_t)pro_bcalls + it * body_bcalls, S, shot);
  }
}

// route 0 "shared" (smem_bytes = 8 nw threads; frames unused), 1 "device"
// (frames: 2 nw x blocks * threads words).  sampler/device.py::frame_plan.
extern "C" int k9_sample(const void* ops, const void* data, const void* args, int n_pro,
                         int n_body, int n_epi, int repeat, int pro_meas, int body_meas,
                         int pro_calls, int body_calls, int pro_bcalls, int body_bcalls, int nw,
                         int S, unsigned long long seed, unsigned long long call0, int route,
                         int blocks, int threads, int smem_bytes, void* frames, void* record,
                         void* stream) {
  if (S < 1 || nw < 1 || n_pro < 0 || n_body < 0 || n_epi < 0 || repeat < 0 || pro_calls < 0 ||
      body_calls < 0 || pro_bcalls < 0 || body_bcalls < 0 || threads < 32 ||
      threads > MAX_THREADS || threads % 32 != 0 || blocks < 1 ||
      (long long)blocks * threads < S || route < 0 || route > 1 || (uintptr_t)ops % 16 != 0 ||
      (uintptr_t)data % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int* o = (const int*)ops;
  const int* d = (const int*)data;
  const float* a = (const float*)args;
  uint8_t* rec = (uint8_t*)record;
  if (route == 0) {
    if (smem_bytes != 8 * nw * threads) return (int)cudaErrorInvalidValue;
    return launch_resident(k9_sample_kernel<true>, blocks, threads, smem_bytes, st, o, d, a,
                           n_pro, n_body, n_epi, repeat, pro_meas, body_meas, pro_calls,
                           body_calls, pro_bcalls, body_bcalls, nw, S, (uint64_t)seed,
                           (uint64_t)call0, (uint32_t*)nullptr, rec);
  }
  if (frames == nullptr || smem_bytes != 0) return (int)cudaErrorInvalidValue;
  k9_sample_kernel<false><<<blocks, threads, 0, st>>>(
      o, d, a, n_pro, n_body, n_epi, repeat, pro_meas, body_meas, pro_calls, body_calls,
      pro_bcalls, body_bcalls, nw, S, (uint64_t)seed, (uint64_t)call0, (uint32_t*)frames, rec);
  return (int)cudaGetLastError();
}
