"""Ordered-statistics decoding (OSD) post-processing for BP.

Replaces the OSD stage of the Cython ``ldpc`` package's ``bposd_decoder``
(reference options consumed at ``reference/python/qldpc/misc/
_experiment.py:218-219,227-228``), implemented on the bit-packed GF(2)
kernels.  Methods follow Roffe et al., "Decoding across the quantum LDPC
code landscape" (arXiv:2005.07016):

  * ``osd0``   — order columns by BP soft output (most-likely-in-error
    first), Gaussian-eliminate to find the most-reliable information set,
    solve with all non-pivot bits 0;
  * ``osd_e``  — exhaustive search over all 2^osd_order assignments of the
    first `osd_order` non-pivot bits;
  * ``osd_cs`` — combination sweep: all weight-1 assignments over the whole
    non-pivot set plus all weight-2 assignments within the first `osd_order`
    non-pivot bits.

Candidates are scored by channel log-likelihood using the BP posterior
probabilities; the minimum-cost solution wins.  OSD is inherently sequential
per shot (per-shot Gaussian elimination), so it runs on host over the few
BP-failed shots only — BP converges for the overwhelming majority of shots
at relevant physical error rates, so statistical parity with the reference
bposd is preserved while the device kernel stays batched (SURVEY.md §7
"hard parts" item 2).
"""
from __future__ import annotations

import numpy as np
from scipy import sparse

from ..utils import gf2, observability

__all__ = ["osd_decode", "osd_decode_batch"]


def _solve_candidates(rref_packed, pivots, order, syndrome_col, n, osd_method, osd_order, cost):
    """Enumerate candidate non-pivot assignments, return the min-cost solution
    in ORIGINAL column coordinates."""
    r_rows = len(pivots)
    num_ordered = len(order)
    pivot_set = set(int(p) for p in pivots)
    nonpivots = [c for c in range(num_ordered) if c not in pivot_set]

    # unpack the relevant part of the RREF once: rows r_rows x (cols + 1 syndrome)
    rref = gf2.unpack_rows(rref_packed, num_ordered + 1)[:r_rows]
    R_nonpiv = rref[:, nonpivots] if nonpivots else np.zeros((r_rows, 0), dtype=np.uint8)
    s_red = rref[:, num_ordered]

    # base solution: non-pivots all zero
    def assemble(t_bits):
        x_ordered = np.zeros(num_ordered, dtype=np.uint8)
        x_piv = s_red.copy()
        if t_bits.size:
            x_piv ^= (R_nonpiv @ t_bits) % 2
        x_ordered[np.asarray(pivots, dtype=np.int64)] = x_piv
        if t_bits.size:
            x_ordered[np.asarray(nonpivots, dtype=np.int64)] = t_bits
        x = np.zeros(n, dtype=np.uint8)
        x[order] = x_ordered
        return x

    k = len(nonpivots)
    candidates = [np.zeros(k, dtype=np.uint8)]
    if osd_method == "osd_e":
        w = min(osd_order, k)
        for pattern in range(1, 1 << w):
            t = np.zeros(k, dtype=np.uint8)
            for b in range(w):
                if (pattern >> b) & 1:
                    t[b] = 1
            candidates.append(t)
    elif osd_method == "osd_cs":
        for i in range(k):
            t = np.zeros(k, dtype=np.uint8)
            t[i] = 1
            candidates.append(t)
        w = min(osd_order, k)
        for i in range(w):
            for j in range(i + 1, w):
                t = np.zeros(k, dtype=np.uint8)
                t[i] = 1
                t[j] = 1
                candidates.append(t)
    elif osd_method != "osd0":
        raise ValueError(f"unknown osd method {osd_method!r}")

    best, best_cost = None, np.inf
    for t in candidates:
        x = assemble(t)
        c = float(cost[x.astype(bool)].sum())
        if c < best_cost:
            best, best_cost = x, c
    return best


def osd_decode(H, syndrome, posterior_llr, osd_method="osd0", osd_order=7):
    """OSD solution for one shot.

    H: (r, n) sparse/dense 0/1; syndrome: (r,); posterior_llr: (n,) BP soft
    output (LLR, negative = likely error).  Returns (n,) uint8 error estimate
    with H @ e = syndrome mod 2 (when the syndrome is in the column space).
    """
    H = sparse.csr_matrix(H)
    r, n = H.shape
    syndrome = np.asarray(syndrome, dtype=np.uint8) % 2
    llr = np.asarray(posterior_llr, dtype=np.float64)

    # reliability order: most likely in error first (ascending LLR)
    order = np.argsort(llr, kind="stable").astype(np.int64)
    Hd = H.toarray().astype(np.uint8) % 2
    H_ordered = Hd[:, order]
    aug = np.hstack([H_ordered, syndrome[:, None]])
    packed = gf2.pack_rows(aug)
    packed, pivots = gf2.row_reduce_packed(packed, aug.shape[1], reduce_cols=n)

    # candidate scoring by posterior channel cost; clip for stability
    q = 1.0 / (1.0 + np.exp(np.clip(llr, -30, 30)))  # P(error)
    q = np.clip(q, 1e-12, 1 - 1e-12)
    cost = np.log((1 - q) / q)
    cost = np.maximum(cost, 1e-9)  # flipping a "certain" bit is free, not negative

    return _solve_candidates(packed, pivots, order, syndrome, n, osd_method, osd_order, cost)


_METHOD_ID = {"osd0": 0, "osd_e": 1, "osd_cs": 2}


def _osd_batch_native(H, syndromes, posterior_llrs, osd_method, osd_order,
                      nthreads=0):
    """Threaded C++ batch OSD (native/gf2_kernels.cpp::osd_batch), or None if
    the native library is unavailable.  Bit-identical to the numpy path up to
    floating-point tie-breaks in candidate scoring (measure-zero for real BP
    posteriors; tests/test_decoders.py pins equality on random batches)."""
    from .. import native
    import ctypes

    lib = native.get_gf2_lib()
    if lib is None or not hasattr(lib, "osd_batch"):
        return None
    Hd = np.ascontiguousarray(sparse.csr_matrix(H).toarray().astype(np.uint8) % 2)
    r, n = Hd.shape
    synd = np.ascontiguousarray(np.asarray(syndromes, dtype=np.uint8) % 2)
    llrs = np.ascontiguousarray(np.asarray(posterior_llrs, dtype=np.float64))
    S = synd.shape[0]
    assert synd.shape == (S, r) and llrs.shape == (S, n)
    out = np.zeros((S, n), dtype=np.uint8)
    with observability.span("redecode.osd"):
        rc = lib.osd_batch(
            Hd.ctypes.data_as(ctypes.c_void_p), r, n,
            synd.ctypes.data_as(ctypes.c_void_p), llrs.ctypes.data_as(ctypes.c_void_p), S,
            _METHOD_ID[osd_method], osd_order, int(nthreads),
            out.ctypes.data_as(ctypes.c_void_p),
        )
    if rc != 0:
        return None
    return out


def osd_decode_batch(H, syndromes, posterior_llrs, osd_method="osd0", osd_order=7,
                     backend="auto", nthreads=0):
    """OSD over a batch of shots.

    ``backend="auto"`` uses the threaded C++ kernel when available (parallel
    over shots — the reference decodes shots one at a time in a Python loop,
    ``reference/python/qldpc/misc/_experiment.py:199-209``) and falls
    back to the per-shot numpy path; ``"numpy"`` forces the fallback.
    ``nthreads`` caps the native worker threads (0 = all hardware threads).
    """
    if osd_method not in _METHOD_ID:
        raise ValueError(f"unknown osd method {osd_method!r}")
    if backend == "auto":
        out = _osd_batch_native(H, syndromes, posterior_llrs, osd_method, osd_order, nthreads)
        if out is not None:
            return out
    elif backend != "numpy":
        raise ValueError(f"unknown backend {backend!r}")
    out = np.zeros((syndromes.shape[0], H.shape[1]), dtype=np.uint8)
    with observability.span("redecode.osd"):
        for i in range(syndromes.shape[0]):
            out[i] = osd_decode(H, syndromes[i], posterior_llrs[i], osd_method, osd_order)
    return out
