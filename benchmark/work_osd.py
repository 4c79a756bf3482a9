"""The least time an H100 could take for the redecode's OSD solves on the
card: the yardstick of ``osd_device_roofline``.

``osd_bound`` and ``SMEM_BYTES_PER_S`` are a frozen copy of the program's
``utils/bounds.py`` (K8's bound), kept here so that a change to the program
cannot move the yardstick: the larger of the words the solves move through
shared memory (8 bytes an XOR word, a read and a write of the row's word;
4 a candidate's word) over the card's shared-memory rate (128 bytes a clock
and SM, 132 SMs at 1,980 MHz), and the bytes they move through device
memory (a shot's ordered columns, LLRs and syndrome in, its answer out)
over 3.35 TB/s.

A solve's words are counted from the matrix's shape and rank alone
(:func:`solve_words`), a lower count of the plain elimination's: the
candidates read a word of every pivot row for each set non-pivot bit (the
base none, each single one, each pair of the first ``order`` two), exact;
each pivot row is XORed into at least one other row, from its pivot's word
on, with the pivots taken as far right as they can lie (the last ``rank``
columns), which touches the fewest words.  The elimination the program runs
XORs each pivot row into every other row that holds its column, about ten
a pivot at the gross shape, so the count errs low.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .reference.codes import rank as gf2_rank
from .reference.codes import read_qecc, spacetime_matrix

HBM_BYTES_PER_S = 3.35e12
SMEM_BYTES_PER_S = 132 * 128 * 1.98e9
CONFIG = Path(__file__).resolve().parent / "configs" / "gross144x12osd.json"


def osd_bound(xor_words: float, cand_words: float, shots: int, rows: int, cols: int) -> dict:
    """The bound of ``shots`` OSD solves of a (rows, cols) matrix whose words
    (``xor_words`` and ``cand_words``, summed over the shots) go through
    shared memory; ``bound_by`` is "shared memory" or "bytes"."""
    smem = 8.0 * xor_words + 4.0 * cand_words
    dm = shots * (13 * cols + rows + cols)
    ts, tb = 1e3 * smem / SMEM_BYTES_PER_S, 1e3 * dm / HBM_BYTES_PER_S
    return {"bound_ms": max(ts, tb), "bound_by": "shared memory" if ts >= tb else "bytes",
            "bound_bytes": int(dm), "bound_smem_bytes": int(smem)}


def solve_words(rows: int, cols: int, rank: int, order: int) -> tuple:
    """(XOR words, candidate words) of one OSD-CS solve of order ``order`` on
    a (rows, cols) matrix of GF(2) rank ``rank``: the lower count above."""
    words = (cols + 1 + 31) // 32
    k = cols - rank
    w = min(order, k)
    xor = sum(words - (k + j) // 32 for j in range(rank))
    return xor, rank * (k + w * (w - 1))


def config_shape(path=CONFIG) -> tuple:
    """(rows, cols, rank, order) of the OSD matrix of a configuration: its
    code file's Z checks over its rounds, as the ``bposd`` redecode solves."""
    cfg = json.loads(Path(path).read_text())
    h = read_qecc(Path(path).parent / cfg["code"]["file"])["hz"]
    st = spacetime_matrix(h, int(cfg["rounds"]))
    return st.shape[0], st.shape[1], gf2_rank(st), int(cfg["osd"]["order"])


_SHAPE = {}


def bound_ms(solves: float, path=CONFIG) -> float:
    """The least time of ``solves`` OSD solves at the configuration's shape."""
    if path not in _SHAPE:
        _SHAPE[path] = config_shape(path)
    rows, cols, rank, order = _SHAPE[path]
    xor, cand = solve_words(rows, cols, rank, order)
    return osd_bound(xor * solves, cand * solves, int(round(solves)), rows, cols)["bound_ms"]
