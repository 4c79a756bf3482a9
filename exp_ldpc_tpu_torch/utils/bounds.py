"""The least time an H100 could take for a BP decode: the yardstick beside
every kernel time that ``chip_smoke.py`` and the benchmarks report.

A bound is the larger of two times: the bytes the decode must move over the
card's device-memory rate, and its arithmetic over the card's peak rate for
its type (NVIDIA H100 SXM: 3.35 TB/s; 67 TFLOP/s in float32 / int32 outside
the tensor cores, since these functions hold no matrix product of their
own).  Each input is read once and each output written once ("on chip");
where one shot's state does not fit on chip (the streamed routes of K2 and
K6) the messages must also go to device memory and back every iteration
(:func:`streamed_bound`).

The matrix-unit probe's dot chain (K7, :func:`dot_chain_bound`) runs on the
tensor cores where its type has them: NVIDIA's dense peaks for the H100 SXM,
989.4 TFLOP/s for bf16 products summed in f32 and 1,978.9 TOP/s for int8
products summed in int32; f32 stays on the CUDA cores' 67 TFLOP/s.  Every
rate here is the card's published peak at its 700 W limit, not a
measurement.

The published peaks are not on one clock: bf16 and int8 are 4,096 and 8,192
operations a clock and SM x 132 SMs at 1,830 MHz, f32 is 256 x 132 at
1,980 MHz, and a card that holds 1,980 MHz under the tensor cores' load runs
past the first two.  :func:`clock_peak` puts every type on the card's own
clock (``nvidia-smi``'s ``clocks.max.sm``) and SM count: the rate no kernel
can pass, which the dot chain's share and its check of left-out work use.

The OSD step of BP+OSD (K8, :func:`osd_bound`) keeps each shot's matrix in
shared memory: its bound is the words its elimination and its candidate
scoring must move through the card's shared memory (128 bytes a clock and
SM, 132 SMs at 1,980 MHz), or its device-memory traffic where that is
larger.

The relay BP ensemble (K10, :func:`relay_bound`) is a flat min-sum decode
whose variable update adds a memory term: its bound counts leg 0 on every
shot and the later legs on none (their work depends on the data), so it
errs low.

The Pauli-frame sampler (K9, :func:`sampler_bound`) writes the record once
and draws its random words from Philox4x32-10: its bound is the record's
bytes over the device-memory rate, or the Philox calls' integer operations
over the card's int32 rate (64 INT32 lanes an SM and clock, 132 SMs at
1,980 MHz), whichever is larger.
"""
from __future__ import annotations

from typing import Optional

__all__ = ["HBM_BYTES_PER_S", "OPS_PER_S", "TENSOR_OPS_PER_S", "OPS_FLOAT", "OPS_INT8",
           "ABLATE_OPS", "bound", "table_bytes", "flat_io", "st_io",
           "streamed_bound", "dot_chain_bound", "DOT_ELEMENT_BYTES", "OPS_PER_CLOCK_SM",
           "clock_peak", "SMEM_BYTES_PER_S", "osd_bound", "INT32_OPS_PER_S", "PHILOX_OPS",
           "sampler_bound", "OPS_MEMORY", "relay_bound"]

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
SMEM_BYTES_PER_S = 132 * 128 * 1.98e9   # H100 SXM shared memory, all SMs
OPS_PER_S = 67e12           # float32 / int32 outside the tensor cores
INT32_OPS_PER_S = 64 * 132 * 1.98e9   # H100 SXM: 64 INT32 lanes an SM and clock
# One Philox4x32-10 call (4 words): 10 rounds of two 32 x 32 bit products, each a low
# and a high half (4), and two three-input XORs (2 LOP3).  The key schedule is the same
# for every call of a thread: the compiler hoists it (K9's SASS adds its constants once).
PHILOX_OPS = 10 * (4 + 2)
# the peak of a product by operand type: the tensor cores' dense rates for
# bf16 (f32 sums) and int8 (int32 sums); f32 products run on the CUDA cores
TENSOR_OPS_PER_S = {"bf16": 989.4e12, "int8": 1978.9e12, "f32": OPS_PER_S}
DOT_ELEMENT_BYTES = {"bf16": 2, "int8": 1, "f32": 4}
# dense operations a clock and SM: the tensor cores' bf16 (f32 sums) and int8
# (int32 sums), and f32 on the CUDA cores (128 lanes of FMA)
OPS_PER_CLOCK_SM = {"bf16": 4096, "int8": 8192, "f32": 256}
# Arithmetic per edge, shot and iteration, counted from the plain versions:
# compares, selects, minima, adds and multiplies only.  A type conversion
# (the bf16 kernels round a message three times) is not counted, so one count
# serves the f32 and the bf16 kernels and errs towards a lower bound.
# Min-sum in float (check_update_cm and the variable update): sign test, sign
# product, abs, min1, min2 select, is-min select, sign multiply, alpha
# multiply (8 on the check side); add into the total, subtract (2 on the
# variable side); the parity xor (1): 11.  int8 (check_update_int,
# int8_step): abs, negative count, min1, min2, is-min select, multiply,
# shift, sign parity, negate-select (9); add, clip, subtract, clip (4);
# parity (1): 14.
OPS_FLOAT, OPS_INT8 = 11, 14
# The relay's memory term per variable, shot and iteration
# (relay_core's lam = (1 - g) * (prior + total) + g * lam): the prior added to
# the total, two products and a sum.  1 - g is once a leg, not counted.
OPS_MEMORY = 4
# K1's profiling hook (experiments/bench_bsr_ablation.py): the operations an
# ablation leaves of OPS_FLOAT, whose check side is 8: "no_check" the
# variable side and the parity (3), "no_route" the check side and the
# copy's negation (9)
ABLATE_OPS = {"": OPS_FLOAT, "no_check": 3, "no_route": 9}


def bound(nbytes: float, ops: float, ops_per_s: float = OPS_PER_S) -> dict:
    """``bound_ms`` (the larger of bytes over :data:`HBM_BYTES_PER_S` and
    operations over ``ops_per_s``, :data:`OPS_PER_S` by default), what sets
    it (``bound_by``: "bytes" or "operations") and both counts."""
    tb, to = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / ops_per_s
    return {"bound_ms": max(tb, to), "bound_by": "bytes" if tb >= to else "operations",
            "bound_bytes": int(nbytes), "bound_ops": int(ops)}


def table_bytes(tab) -> int:
    """The int32 Tanner tables: check -> slot variables, variable -> slots."""
    return 4 * (tab.num_checks * tab.max_check_degree + tab.num_vars * tab.max_var_degree)


def flat_io(tab, shots: int) -> int:
    """Bytes a whole flat decode must move: syndromes (u8), priors (f32) and
    the tables in; posterior (f32), conv (u8) and iters (i32) out."""
    C, V = tab.num_checks, tab.num_vars
    return C * shots + 4 * V + table_bytes(tab) + 4 * V * shots + 5 * shots


def st_io(rows: int, cols: int, tab, shots: int) -> int:
    """Bytes a whole spacetime decode must move over the (rows, cols)
    spacetime matrix: syndromes and priors in, the base tables, posterior,
    conv and iters out."""
    return rows * shots + 4 * cols + table_bytes(tab) + 4 * cols * shots + 5 * shots


def streamed_bound(io: int, rows: int, tab, nnz: int, shots: int, iters: int) -> dict:
    """The device-memory bound of a streamed decode of ``shots`` shots over a
    matrix of ``rows`` checks and ``nnz`` edges (Tanner tables ``tab``): its
    inputs and outputs once (``io``, :func:`flat_io` / :func:`st_io`), and
    every iteration the syndromes and tables again and one read and one
    write of each f32 message."""
    per_iter = rows * shots + table_bytes(tab) + 2 * 4 * nnz * shots
    return bound(io + iters * per_iter, OPS_FLOAT * nnz * shots * iters)


def clock_peak(dtype: str, sms: int, mhz: float) -> float:
    """Operations a second of ``dtype`` on ``sms`` SMs at ``mhz``
    (:data:`OPS_PER_CLOCK_SM`)."""
    return OPS_PER_CLOCK_SM[dtype] * sms * mhz * 1e6


def dot_chain_bound(dtype: str, chain: int, S: int = 128,
                    ops_per_s: Optional[float] = None) -> dict:
    """The bound of one dot chain (K7, ``experiments/bench_mxu_dtypes.py``):
    ``chain`` dots of 2 * 128 * 128 * S operations at ``ops_per_s`` (by
    default the published peak of ``dtype``, "bf16", "int8" or "f32",
    :data:`TENSOR_OPS_PER_S`); a (1024, 128) and b (8192, S) read once, the
    (128, S) f32 output written once.  Bound by operations at every type and
    chain the probe runs."""
    elt = DOT_ELEMENT_BYTES[dtype]
    nbytes = elt * (1024 * 128 + 8192 * S) + 4 * 128 * S
    return bound(nbytes, 2.0 * 128 * 128 * S * chain, ops_per_s or TENSOR_OPS_PER_S[dtype])


def osd_bound(xor_words: float, cand_words: float, shots: int, rows: int, cols: int) -> dict:
    """K8's bound for ``shots`` OSD solves of an (rows, cols) matrix: in
    shared memory, each XOR of a row word by the pivot's word reads and
    writes the row's word (the pivot's word is a broadcast, not counted),
    and each candidate reads a word of every pivot row a set non-pivot bit
    touches (``xor_words`` and ``cand_words`` summed over the shots); in
    device memory, a shot's ordered columns (int32), LLRs (float64) and
    syndrome (u8) in, its answer (u8) out.  ``bound_by`` is "shared memory"
    or "bytes"."""
    smem = 8.0 * xor_words + 4.0 * cand_words
    dm = shots * (13 * cols + rows + cols)
    ts, tb = 1e3 * smem / SMEM_BYTES_PER_S, 1e3 * dm / HBM_BYTES_PER_S
    return {"bound_ms": max(ts, tb), "bound_by": "shared memory" if ts >= tb else "bytes",
            "bound_bytes": int(dm), "bound_smem_bytes": int(smem)}


def sampler_bound(calls: int, shots: int, measurements: int) -> dict:
    """K9's bound for a batch of ``shots`` shots that make ``calls``
    Philox4x32-10 calls each (``sampler/device.py::fixed_calls``: those every
    shot makes) and write a record of ``measurements`` bytes each:
    :data:`PHILOX_OPS` a call over :data:`INT32_OPS_PER_S`, or the record
    over the device-memory rate.  The frames stay on chip, the op table and
    noise vector are read once a block from the cache (not counted)."""
    return bound(measurements * shots, PHILOX_OPS * calls * shots, INT32_OPS_PER_S)


def relay_bound(tab, nnz: int, shots: int, iters: int, legs: int) -> dict:
    """K10's bound for one relay decode of ``shots`` shots over a matrix of
    ``nnz`` edges (Tanner tables ``tab``), ``iters`` iterations a leg and
    ``legs`` legs: :func:`flat_io` with the (legs, V) f32 gamma table read
    once (the solving leg, int32, takes the place of the iteration count);
    :data:`OPS_FLOAT` an edge and :data:`OPS_MEMORY` a variable, each shot
    and iteration of leg 0 only, whatever the later legs do."""
    V = tab.num_vars
    ops = (OPS_FLOAT * nnz + OPS_MEMORY * V) * shots * iters
    return bound(flat_io(tab, shots) + 4 * legs * V, ops)
