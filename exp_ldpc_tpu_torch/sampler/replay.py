"""A numpy replay of kernel K9 (``csrc/sampler.cu``), the reference it is
held to bit for bit.

:func:`replay` rebuilds K9's record from its op table
(:func:`device.op_table`), the noise vector and the Philox4x32-10 key and
first call: op by op, chunk by chunk, target (or edge) by target, each
drawing the words the kernel draws where the kernel draws them, all shots
at once.  Its Philox is held to Random123's known answers and its draws to
``FrameSampler`` in distribution (``tests/test_torch_sampler.py``), so a
kernel that draws the right rates from the wrong words (one word shared by
a chunk's targets, say) differs from it.  :func:`shift_qubits` moves a
circuit's qubits by whole frame words: the same chunks and draws, frames
past a block's shared memory (K9's device-memory route).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from .device import OpTable, _CORRELATED, _NAMES

__all__ = ["philox4x32_10", "table_ops", "chunk_targets", "pass_edges", "replay",
           "shift_qubits"]

_MASK = np.uint64(0xFFFFFFFF)
_M0, _M1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
_W0, _W1 = np.uint64(0x9E3779B9), np.uint64(0xBB67AE85)
_TWO32 = 4294967296.0


def philox4x32_10(ctr, key):
    """Philox4x32-10 of the four 32-bit counter words (arrays) under the two
    key words: the four output words, as ``csrc/sampler.cu::philox``."""
    c0, c1, c2, c3 = (np.asarray(x, dtype=np.uint64) for x in ctr)
    k0, k1 = np.uint64(key[0]), np.uint64(key[1])
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        p0, p1 = _M0 * c0, _M1 * c2
        c0, c1, c2, c3 = (p1 >> np.uint64(32)) ^ c1 ^ k0, p1 & _MASK, \
            (p0 >> np.uint64(32)) ^ c3 ^ k1, p0 & _MASK
    return c0, c1, c2, c3


class _Stream:
    """Every shot's calls of one stream (0 noise words, 1 frame bits), keyed
    by the seed, call ``call0`` + ``call``: four word arrays.  The last call
    of each stream is kept (chunks share a call of frame bits, pairs a call
    of noise words)."""

    def __init__(self, seed: int, call0: int, shots: int):
        self.key = (seed & 0xFFFFFFFF, seed >> 32)
        self.call0 = call0
        self.shot = np.arange(shots, dtype=np.uint64)
        self.last = {}

    def __call__(self, call: int, stream: int = 0):
        hit = self.last.get(stream)
        if hit is None or hit[0] != call:
            n = np.full(self.shot.size, self.call0 + call, dtype=np.uint64)
            hit = self.last[stream] = (call, philox4x32_10(
                (n & _MASK, n >> np.uint64(32), self.shot, np.full_like(n, stream)), self.key))
        return hit[1]


def _threshold(p) -> np.uint64:
    t = float(np.float32(p)) * _TWO32
    if not t > 0.0:
        return np.uint64(0)
    return np.uint64(2**32 if t >= _TWO32 else int(np.ceil(t)))


def _below(u, thr):
    return (u < thr).astype(np.uint8)


def _uniform_1_to(u, k: int):
    return (np.uint64(1) + ((u * np.uint64(k)) >> np.uint64(32))).astype(np.uint8)


def table_ops(table: OpTable):
    """The table read back, a list a block of (name, targets, Pauli codes or
    None, noise slots, first noise slot, meas_offset) per op."""
    out, row = [], 0
    for n_ops in table.block_ops:
        block = []
        for code, n, off, arg, meas, k, extra, *_ in table.ops[row: row + n_ops].tolist():
            name = _NAMES[code]
            block.append((name, table.data[off: off + n],
                          table.data[extra: extra + n] if name in _CORRELATED else None,
                          k, arg, meas))
        out.append(block)
        row += n_ops
    return out


def chunk_targets(table: OpTable, extra: int, nch: int) -> List[list]:
    """A single-qubit op's chunks: [(slot, qubit) of the real targets...,
    first target's index] each."""
    out = []
    for w0, lo, hi, i0 in table.data[extra: extra + 4 * nch].view(np.uint32).reshape(-1, 4):
        w0, lo, hi = int(w0), int(lo), int(hi)
        bits = [((lo if j < 4 else hi) >> (8 * (j % 4))) & 31 for j in range(8)]
        out.append([(j, 32 * (w0 & 0xFFFFFF) + bits[j]) for j in range(8) if w0 >> 24 >> j & 1]
                   + [int(i0)])
    return out


def pass_edges(table: OpTable, extra: int, nch: int) -> List[Tuple[int, int]]:
    """A pass's edges (src, dst), chunk after chunk."""
    out = []
    for row in table.data[extra: extra + 12 * nch].view(np.uint32).reshape(-1, 12):
        w0, lo, hi = int(row[0]), int(row[1]), int(row[2])
        for j in range(8):
            if w0 >> 24 >> j & 1:
                dbit = ((lo if j < 4 else hi) >> (8 * (j % 4))) & 31
                out.append((int(row[4 + j]), 32 * (w0 & 0xFFFFFF) + dbit))
    return out


def replay(table: OpTable, args: np.ndarray, seed: int, call0: int, shots: int):
    """K9's record, (M, shots) uint8, from the op table, the noise vector
    and the streams' key and first call; also the calls made on each
    stream."""
    args = np.asarray(args, dtype=np.float32)
    fr = np.zeros((2, max(table.num_qubits, 1), shots), dtype=np.uint8)   # X, Z
    rec = np.zeros((table.num_measurements, shots), dtype=np.uint8)
    rng = _Stream(seed, call0, shots)
    n_pro, n_body, _ = table.block_ops
    (pc, bc, _), (pb, bb, _) = table.block_calls, table.block_bit_calls
    pm, bm = table.prologue_measurements, table.body_measurements
    rows = [table.ops[:n_pro], table.ops[n_pro: n_pro + n_body], table.ops[n_pro + n_body:]]
    blocks = [(rows[0], 0, 0, 0)] + [(rows[1], pm + it * bm, pc + it * bc, pb + it * bb)
                                     for it in range(table.repeat)]
    r = table.repeat
    blocks.append((rows[2], pm + r * bm, pc + r * bc, pb + r * bb))
    calls = [0, 0]
    for ops, base, cbase, bbase in blocks:
        chain = np.zeros(shots, dtype=np.uint8)
        for code, n, off, arg, meas, k, extra, nch, nch2, call, bcall, _ in ops.tolist():
            name = _NAMES[code]
            call, bcall = cbase + call, bbase + bcall
            t = table.data[off: off + n].tolist()
            thr = _threshold(args[arg]) if k else None
            if name in ("RZ", "RX", "MZ", "MX", "MRZ", "MRX"):
                read, other = (0, 1) if name in ("RZ", "MZ", "MRZ") else (1, 0)
                for c, (*targets, i0) in enumerate(chunk_targets(table, extra, nch)):
                    g = rng(bcall + c // 16, 1)[(c // 4) % 4] >> np.uint64(8 * (c % 4))
                    w = list(rng(call + 2 * c)) + list(rng(call + 2 * c + 1)) if k else None
                    for j, q in targets:
                        if name[0] == "M":
                            e = _below(w[j], thr) if k else 0
                            rec[base + meas + i0 + j] = fr[read, q] ^ e
                        if name[0] == "R" or name.startswith("MR"):
                            fr[read, q] = 0
                        fr[other, q] = ((g >> np.uint64(j)) & np.uint64(1)).astype(np.uint8)
                    calls[1] = max(calls[1], bcall + c // 16 + 1)
                    calls[0] = max(calls[0], call + 2 * c + 2 if k else 0)
            elif name in ("CX", "CZ"):
                passes = ([(extra, nch, 0, 0), (extra + 12 * nch, nch2, 1, 1)] if name == "CX"
                          else [(extra, nch, 0, 1)])
                for e_off, e_n, sp, dp in passes:
                    for src, dst in pass_edges(table, e_off, e_n):
                        fr[dp, dst] ^= fr[sp, src]
            elif name in ("DEPOLARIZE1", "X_ERROR", "Y_ERROR", "Z_ERROR", "PAULI_CHANNEL_1"):
                per = 4 if name == "DEPOLARIZE1" else 2
                for c, (*targets, _i0) in enumerate(chunk_targets(table, extra, nch)):
                    w = list(rng(call + per * c)) + list(rng(call + per * c + 1))
                    calls[0] = max(calls[0], call + per * c + per)
                    if name == "DEPOLARIZE1":
                        pw = list(rng(call + 4 * c + 2)) + list(rng(call + 4 * c + 3))
                        for j, q in targets:
                            kk = _uniform_1_to(pw[j], 3) * _below(w[j], thr)
                            fr[0, q] ^= kk & 1
                            fr[1, q] ^= (kk >> 1) & 1
                    elif name == "PAULI_CHANNEL_1":
                        px = args[arg]
                        pxy = np.float32(px + args[arg + 1])
                        t1, t2 = _threshold(px), _threshold(pxy)
                        t3 = _threshold(np.float32(pxy + args[arg + 2]))
                        for j, q in targets:
                            fr[0, q] ^= _below(w[j], t2)
                            fr[1, q] ^= (1 - _below(w[j], t1)) & _below(w[j], t3)
                    else:
                        for j, q in targets:
                            e = _below(w[j], thr)
                            fr[0, q] ^= e if name != "Z_ERROR" else 0
                            fr[1, q] ^= e if name != "X_ERROR" else 0
            elif name == "DEPOLARIZE2":
                for i in range(0, n, 2):
                    a, b = t[i], t[i + 1]
                    wr = rng(call + i // 4)
                    kk = _uniform_1_to(wr[i % 4 + 1], 15) * _below(wr[i % 4], thr)
                    calls[0] = max(calls[0], call + i // 4 + 1)
                    fr[0, a] ^= kk & 1
                    fr[1, a] ^= (kk >> 1) & 1
                    fr[0, b] ^= (kk >> 2) & 1
                    fr[1, b] ^= (kk >> 3) & 1
            elif name == "PAULI_CHANNEL_2":
                cum, thrs = np.float32(0.0), []
                for jj in range(15):
                    cum = np.float32(cum + args[arg + jj])
                    thrs.append(_threshold(cum))
                for i in range(0, n, 2):
                    a, b = t[i], t[i + 1]
                    u = rng(call + i // 8)[(i // 2) % 4]
                    calls[0] = max(calls[0], call + i // 8 + 1)
                    region = 1 + sum((1 - _below(u, th)).astype(np.int64) for th in thrs)
                    hit, pa, pb = region <= 15, region >> 2, region & 3
                    fr[0, a] ^= (hit & ((pa == 1) | (pa == 2))).astype(np.uint8)
                    fr[1, a] ^= (hit & ((pa == 2) | (pa == 3))).astype(np.uint8)
                    fr[0, b] ^= (hit & ((pb == 1) | (pb == 2))).astype(np.uint8)
                    fr[1, b] ^= (hit & ((pb == 2) | (pb == 3))).astype(np.uint8)
            else:   # E / ELSE
                draw = _below(rng(call)[0], thr)
                calls[0] = max(calls[0], call + 1)
                if name == "CORRELATED_ERROR":
                    fired = chain = draw
                else:
                    fired = draw & (1 - chain)
                    chain = chain | fired
                for q, pc_ in zip(t, table.data[extra: extra + n].tolist()):
                    fr[0, q] ^= fired & (pc_ in (1, 2))
                    fr[1, q] ^= fired & (pc_ in (2, 3))
    return rec, tuple(calls)


def shift_qubits(parsed, words: int):
    """``parsed`` with qubit q relabelled q + 32 ``words``: each target keeps
    its bit in its word, so K9 cuts the same chunks and draws the same
    record, its frames past a block's shared memory."""
    def ops(block):
        return [dataclasses.replace(op, targets=np.asarray(op.targets) + 32 * words)
                for op in block]
    return dataclasses.replace(parsed, num_qubits=parsed.num_qubits + 32 * words,
                               prologue=ops(parsed.prologue), body=ops(parsed.body),
                               epilogue=ops(parsed.epilogue))
