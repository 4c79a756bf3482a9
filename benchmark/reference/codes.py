"""Codes and GF(2) linear algebra of the reference, in plain NumPy."""
from __future__ import annotations

from pathlib import Path

import numpy as np


def read_qecc(path) -> dict:
    """A ``qecc`` text file: header ``qecc <n> <#X> <#Z> <#L>``, then one
    line per row (support columns, then the kind ``X``/``Z``/``LX``/``LZ``);
    ``c`` lines are comments.  Returns dense uint8 ``hx``, ``hz``, ``lx``,
    ``lz``."""
    rows = {"X": [], "Z": [], "LX": [], "LZ": []}
    n = None
    for line in Path(path).read_text().splitlines():
        f = line.split()
        if not f or f[0] == "c":
            continue
        if n is None:
            if f[0] != "qecc":
                raise ValueError(f"{path}: not a qecc file")
            n = int(f[1])
            continue
        rows[f[-1]].append([int(x) for x in f[:-1]])
    out = {}
    for kind, sup in rows.items():
        m = np.zeros((len(sup), n), dtype=np.uint8)
        for i, cols in enumerate(sup):
            m[i, cols] = 1
        out["h" + kind.lower() if len(kind) == 1 else kind.lower()] = m
    return out


def bivariate_bicycle(l: int, m: int, a_terms, b_terms):
    """(hx, hz) of the bivariate bicycle code with A, B the sums of the
    monomials x^i y^j of ``a_terms`` / ``b_terms`` (x = S_l kron I_m,
    y = I_l kron S_m): hx = [A | B], hz = [B^T | A^T] (arXiv:2308.07915)."""
    def poly(terms):
        out = np.zeros((l * m, l * m), dtype=np.uint8)
        for i, j in terms:
            out ^= np.kron(np.roll(np.eye(l, dtype=np.uint8), i, axis=1),
                           np.roll(np.eye(m, dtype=np.uint8), j, axis=1))
        return out
    A, B = poly(a_terms), poly(b_terms)
    return np.hstack([A, B]), np.hstack([B.T, A.T])


def rref(M: np.ndarray):
    """Reduced row echelon form over GF(2): (R, pivot columns)."""
    R = (np.asarray(M) % 2).astype(np.uint8).copy()
    pivots, row = [], 0
    for col in range(R.shape[1]):
        hit = np.nonzero(R[row:, col])[0]
        if hit.size == 0:
            continue
        p = row + hit[0]
        R[[row, p]] = R[[p, row]]
        others = np.nonzero(R[:, col])[0]
        others = others[others != row]
        R[others] ^= R[row]
        pivots.append(col)
        row += 1
        if row == R.shape[0]:
            break
    return R[:row], pivots


def rank(M: np.ndarray) -> int:
    return len(rref(M)[1])


def nullspace(M: np.ndarray) -> np.ndarray:
    """A basis (rows) of {v : M v = 0} over GF(2)."""
    R, piv = rref(M)
    n = M.shape[1]
    free = [c for c in range(n) if c not in set(piv)]
    out = np.zeros((len(free), n), dtype=np.uint8)
    for k, f in enumerate(free):
        out[k, f] = 1
        for i, p in enumerate(piv):
            out[k, p] = R[i, f]
    return out


def canonical_logicals(h_same: np.ndarray, h_other: np.ndarray) -> np.ndarray:
    """The operators of one type that commute with the other type's checks
    (``h_other`` v = 0) and vanish on the pivot columns of ``h_same``'s
    reduced row echelon form: k independent rows, one representative of
    each class modulo ``h_same``'s rows, and a choice fixed by the two
    matrices alone.  Its span is what the program's GF(2) construction of
    a generated code's logicals spans (kernel vectors reduced modulo the
    checks' echelon pivots), so a residual that leaves a syndrome reads
    alike on both sides; one that leaves none reads alike with any
    representatives."""
    h_same, h_other = np.asarray(h_same) % 2, np.asarray(h_other) % 2
    _, piv = rref(h_same)
    sel = np.zeros((len(piv), h_same.shape[1]), dtype=np.uint8)
    sel[np.arange(len(piv)), piv] = 1
    return nullspace(np.vstack([h_other, sel]).astype(np.uint8))


def spacetime_matrix(h: np.ndarray, rounds: int) -> np.ndarray:
    """(rounds+1) copies of ``h`` on the diagonal (round-major data
    columns), then rounds*r measurement-error columns: column (b, c)
    touches check c of round blocks b and b+1."""
    r, n = h.shape
    B = rounds + 1
    out = np.zeros((B * r, B * n + rounds * r), dtype=np.uint8)
    for b in range(B):
        out[b * r:(b + 1) * r, b * n:(b + 1) * n] = h
    for b in range(rounds):
        for c in range(r):
            out[b * r + c, B * n + b * r + c] = 1
            out[(b + 1) * r + c, B * n + b * r + c] = 1
    return out


def llr(p) -> np.ndarray:
    """Error probabilities -> float32 LLRs log((1-p)/p), clipped."""
    p = np.clip(np.asarray(p, dtype=np.float64), 1e-12, 1 - 1e-12)
    return np.log((1 - p) / p).astype(np.float32)
