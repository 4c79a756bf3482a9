"""Quantum code file I/O — format-compatible with the reference.

On-disk format (interop contract, see ``reference/python/qldpc/
quantum_code_io.py:12-16``): a header line ``qecc <n> <#X> <#Z> <#L>``,
then one line per stabilizer/logical row written as the row's support
columns followed by a kind tag (``X``/``Z``/``LX``/``LZ``); lines starting
with ``c`` are comments.  Codes written by the reference load here and
vice versa.  The parser below is table-driven over the kind tags and its
diagnostics are our own — only the byte format is shared.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
from scipy import sparse

from ..core import (
    QuantumCode,
    QuantumCodeChecks,
    QuantumCodeLogicals,
    make_check_matrix,
    num_rows,
)

__all__ = ["read_quantum_code", "write_quantum_code"]

_HEADER_TAG = "qecc"
_ROW_KINDS = ("X", "Z", "LX", "LZ")


class CodeFileError(RuntimeError):
    """Malformed ``qecc`` file (bad header, row, or count mismatch)."""


def _parse_header(fields: List[str]) -> Dict[str, int]:
    if len(fields) != 5 or fields[0] != _HEADER_TAG:
        raise CodeFileError(
            "bad qecc header — want 'qecc <# qubits> <# X checks> "
            "<# Z checks> <# logicals>', got: " + " ".join(fields)
        )
    try:
        n, nx, nz, nl = (int(f) for f in fields[1:])
    except ValueError as exc:
        raise CodeFileError(f"non-integer count in qecc header: {exc}") from exc
    if nx + nz > n:
        raise CodeFileError(
            f"header declares more checks ({nx} X + {nz} Z) than qubits ({n})"
        )
    return {"n": n, "X": nx, "Z": nz, "LX": nl, "LZ": nl}


def read_quantum_code(stream, validate_stabilizer_code=None) -> QuantumCode:
    """Parse a ``qecc`` text stream into a :class:`QuantumCode`.

    With ``validate_stabilizer_code`` (default True) the CSS commutation
    relations are verified after parsing, matching the reference's load-time
    validation (``quantum_code_io.py:51-60``).
    """
    if validate_stabilizer_code is None:
        validate_stabilizer_code = True

    header = None
    supports: Dict[str, List[List[int]]] = {k: [] for k in _ROW_KINDS}
    for lineno, raw in enumerate(stream.readlines(), start=1):
        fields = raw.split()
        if not fields or fields[0] == "c":
            continue
        if header is None:
            header = _parse_header(fields)
            continue
        kind = fields[-1]
        if kind not in supports:
            raise CodeFileError(
                f"line {lineno}: unknown row kind {kind!r} "
                f"(expected one of {', '.join(_ROW_KINDS)})"
            )
        try:
            support = [int(f) for f in fields[:-1]]
        except ValueError as exc:
            raise CodeFileError(f"line {lineno}: non-integer qubit index: {exc}") from exc
        bad = [q for q in support if not 0 <= q < header["n"]]
        if bad:
            raise CodeFileError(
                f"line {lineno}: qubit index {bad[0]} outside [0, {header['n']})"
            )
        supports[kind].append(support)

    if header is None:
        raise CodeFileError("empty file: no qecc header line found")

    for kind in _ROW_KINDS:
        if len(supports[kind]) != header[kind]:
            raise CodeFileError(
                f"row count mismatch for {kind}: header says {header[kind]}, "
                f"file has {len(supports[kind])}"
            )

    n = header["n"]
    checks = QuantumCodeChecks(
        make_check_matrix(supports["X"], n), make_check_matrix(supports["Z"], n)
    )
    logicals = QuantumCodeLogicals(
        make_check_matrix(supports["LX"], n).toarray(),
        make_check_matrix(supports["LZ"], n).toarray(),
    )

    if validate_stabilizer_code:
        _validate_css(checks, logicals)
    return QuantumCode(checks, logicals)


def _validate_css(checks: QuantumCodeChecks, logicals: QuantumCodeLogicals) -> None:
    if np.any((checks.x @ checks.z.transpose()).data % 2):
        raise CodeFileError(
            "stabilizer validation failed: some X and Z check rows "
            "anticommute, so the checks do not generate an abelian group"
        )
    if logicals.num_logicals:
        if np.any((checks.x @ logicals.z.transpose()) % 2):
            raise CodeFileError(
                "stabilizer validation failed: a Z logical anticommutes "
                "with an X check"
            )
        if np.any((checks.z @ logicals.x.transpose()) % 2):
            raise CodeFileError(
                "stabilizer validation failed: an X logical anticommutes "
                "with a Z check"
            )


def _row_supports(matrix):
    """Yield each row's support columns for a sparse CSR or dense matrix."""
    if sparse.issparse(matrix):
        csr = matrix.tocsr()
        for i in range(csr.shape[0]):
            yield csr.indices[csr.indptr[i] : csr.indptr[i + 1]]
    else:
        for row in np.asarray(matrix):
            yield np.nonzero(row)[0]


def write_quantum_code(stream, code: QuantumCode) -> None:
    """Serialize ``code`` in the shared ``qecc`` format.

    Section order X, Z, LZ, LX matches the reference writer
    (``quantum_code_io.py:64-71``) so diffs against reference-written files
    stay clean.
    """
    counts = (code.num_qubits, num_rows(code.checks.x), num_rows(code.checks.z),
              code.num_logicals)
    stream.write(_HEADER_TAG + " " + " ".join(str(v) for v in counts) + "\n")
    sections = (
        ("X", code.checks.x),
        ("Z", code.checks.z),
        ("LZ", code.logicals.z),
        ("LX", code.logicals.x),
    )
    for tag, matrix in sections:
        for support in _row_supports(matrix):
            stream.write(" ".join(str(int(q)) for q in support) + f" {tag}\n")
