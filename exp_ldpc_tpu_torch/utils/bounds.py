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
"""
from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "OPS_PER_S", "OPS_FLOAT", "OPS_INT8", "bound", "table_bytes",
           "flat_io", "st_io", "streamed_bound"]

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
OPS_PER_S = 67e12           # float32 / int32 outside the tensor cores
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


def bound(nbytes: float, ops: float) -> dict:
    """``bound_ms`` (the larger of bytes over :data:`HBM_BYTES_PER_S` and
    operations over :data:`OPS_PER_S`), what sets it (``bound_by``: "bytes"
    or "operations") and both counts."""
    tb, to = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / OPS_PER_S
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
