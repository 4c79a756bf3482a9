"""The least time an H100 could take for a BP stage: the yardstick of
``decode_roofline``.

A frozen copy of the program's ``utils/bounds.py`` (``bound``,
``table_bytes``, ``flat_io``, ``st_io`` and the constants they read), kept
here so that a change to the program cannot move the yardstick.  A bound is
the larger of the bytes the stage must move over the card's device-memory
rate and its arithmetic over the card's float32 rate outside the tensor
cores (NVIDIA H100 SXM: 3.35 TB/s, 67 TFLOP/s; the published peaks at the
700 W limit).  Each input is read once and each output written once.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
# min-sum in float per edge, shot and iteration: 8 on the check side, 2 on
# the variable side, the parity xor
OPS_FLOAT = 11


def bound(nbytes: float, ops: float, ops_per_s: float = OPS_PER_S) -> dict:
    """``bound_ms``: the larger of bytes over :data:`HBM_BYTES_PER_S` and
    operations over ``ops_per_s``; ``bound_by`` says which."""
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
