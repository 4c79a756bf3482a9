"""Block-circulant (quasi-cyclic) structure metadata for CSS codes.

The production code families — bivariate bicycle codes, Panteleev–Kalachev
QC lifted products (reference ``reference/python/qldpc/
qc_lifted_product_code.py``), and lifted products over abelian groups
(``Zqm`` in the reference's ``lifted_product_code.py:106-140``) — have check
matrices that are grids of circulant blocks, possibly after a row/column
permutation.  On TPU that structure converts message routing from gathers /
one-hot matmuls into cyclic rolls (:mod:`exp_ldpc_tpu.decoders.qc_bp`), so
constructors that know it record it here and the decoder factory picks it up.

Permutation convention: every ``*_perm`` array maps NEW index -> OLD index,
i.e. ``H_qc = H[check_perm][:, qubit_perm]`` is the block-circulant matrix.
``None`` means identity.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

__all__ = ["BlockCirculantMeta", "invert_perm"]


def invert_perm(perm: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """Inverse of a new->old permutation (old->new)."""
    if perm is None:
        return None
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
    return inv


@dataclass(frozen=True)
class BlockCirculantMeta:
    """Circulant-block layout of a CSS code's check matrices.

    ``dims`` are the cyclic factor sizes (block size = prod(dims)); the
    permutations bring each sector into block-circulant order (new->old,
    ``None`` = already circulant).  X and Z checks have independent row
    orders; qubits share one column order.
    """

    dims: Tuple[int, ...]
    qubit_perm: Optional[np.ndarray] = None
    x_check_perm: Optional[np.ndarray] = None
    z_check_perm: Optional[np.ndarray] = None

    def __post_init__(self):
        object.__setattr__(self, "dims", tuple(int(d) for d in self.dims))
        for name in ("qubit_perm", "x_check_perm", "z_check_perm"):
            p = getattr(self, name)
            if p is not None:
                p = np.asarray(p, dtype=np.int64)
                p.flags.writeable = False
                object.__setattr__(self, name, p)

    @property
    def block_size(self) -> int:
        return int(np.prod(self.dims))

    def check_perm(self, sector: str) -> Optional[np.ndarray]:
        if sector not in ("x", "z"):
            raise ValueError(f"sector must be 'x' or 'z', got {sector!r}")
        return self.x_check_perm if sector == "x" else self.z_check_perm
