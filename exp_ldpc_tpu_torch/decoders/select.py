"""Decoder selection: route each code to its kernel.

Counterpart of ``exp_ldpc_tpu/decoders/select.py``, with the JAX rules kept
as they are:

  * :func:`make_bp_decoder` (flat BP): from ~1 MiB of dense routing
    operands up, where "usable" (a CUDA device, the counterpart of
    ``_bsr_usable``), kernel K1 (:class:`.bp_bsr.BSRBPDecoder`, early exit
    per shot block); else, with ``qc_dims`` given, the quasi-cyclic roll
    decoder (:class:`.qc_bp.QCBPDecoder`) where its monomial count and the
    operand size are in its range; else :class:`.bp.BPDecoder`.  The int8
    message path (kernel K5) is passed through when asked for by
    ``msg_dtype="int8"`` and never chosen.
  * :func:`make_spacetime_bp_decoder`: from the same threshold up (and
    rounds >= 1) the K3 contract
    (:class:`.bp_bsr_spacetime.SpacetimeBSRDecoder`, global early exit),
    below it the structured decoder (:class:`.spacetime_bp.SpacetimeBPDecoder`:
    K2 in fixed-iteration mode).  "Usable" for K3 means a CUDA device.

The thresholds were measured on a TPU v5e; re-deriving them on the H100 is
a ROADMAP item.
"""
from __future__ import annotations

import warnings
from typing import Dict

import numpy as np
import torch
from scipy import sparse

from ..utils.device import DeviceLike, resolve_device
from .bp import dense_ops_bytes
from .tanner import TannerELL

__all__ = ["make_bp_decoder", "make_spacetime_bp_decoder", "bsr_selected", "stbsr_selected",
           "qc_kwargs_for_code", "qc_kwargs_single_shot"]

# exp_ldpc_tpu/decoders/select.py:45 (v5e crossover)
BSR_MIN_OPS_BYTES = 2**20
# exp_ldpc_tpu/decoders/select.py:31, :38 (the quasi-cyclic roll decoder's range)
_QC_MAX_MONOMIALS = 256
_QC_PREFER_DENSE_OPS_LIMIT = 4 * 2**20


def _ops_bytes(tanner) -> int:
    return dense_ops_bytes(tanner.num_vars, tanner.num_checks, tanner.max_check_degree)


def bsr_selected(tanner, device: torch.device) -> bool:
    """True where the JAX rule picks the flat K1 contract."""
    return _ops_bytes(tanner) >= BSR_MIN_OPS_BYTES and device.type == "cuda"


def stbsr_selected(tanner, num_rounds: int, device: torch.device) -> bool:
    """True where the JAX rule picks the streamed K3 contract."""
    return num_rounds >= 1 and _ops_bytes(tanner) >= BSR_MIN_OPS_BYTES \
        and device.type == "cuda"


def make_bp_decoder(H, *, qc_dims=None, qc_check_perm=None, qc_var_perm=None,
                    device: DeviceLike = "cuda", **opts):
    """Flat BP on ``device`` with the JAX package's automatic choice.
    ``opts`` are the decoders' ``from_check_matrix`` options; the BSR-only
    ``shot_block``, ``msg_dtype`` and ``prior_quanta`` are dropped where
    another decoder is chosen (as JAX ignores them there).

    The choice never falls on the int8 message path (kernel K5): it is kept
    for ablations, and a caller opts in with ``msg_dtype="int8"``."""
    from .bp import BPDecoder
    from .bp_bsr import BSRBPDecoder
    from .qc_bp import QCBPDecoder

    if opts.get("msg_dtype") == "int8":
        warnings.warn(
            "msg_dtype='int8' is an ablation-only path: the automatic choice is the bf16 "
            "kernel at equal accuracy", stacklevel=2)
    dev = resolve_device(device)
    H = sparse.csr_matrix(H)
    tanner = TannerELL.from_check_matrix(H)
    if bsr_selected(tanner, dev):
        return BSRBPDecoder.from_check_matrix(H, check_perm=qc_check_perm, var_perm=qc_var_perm,
                                              device=dev, **opts)
    if qc_dims is not None:
        L = int(np.prod(qc_dims))
        if H.nnz // L <= _QC_MAX_MONOMIALS and _ops_bytes(tanner) > _QC_PREFER_DENSE_OPS_LIMIT:
            # K1 not usable (no card): the roll decoder is the next structured choice
            return QCBPDecoder.from_check_matrix(H, qc_dims, check_perm=qc_check_perm,
                                                 var_perm=qc_var_perm, device=dev, **opts)
    opts = {k: v for k, v in opts.items()
            if k not in ("shot_block", "msg_dtype", "prior_quanta")}
    return BPDecoder.from_check_matrix(H, device=dev, **opts)


def make_spacetime_bp_decoder(H, num_rounds: int, *, device: DeviceLike = "cuda", **opts):
    """Multi-round spacetime BP on ``device`` with automatic kernel choice;
    ``H`` is the BASE check matrix."""
    from .bp_bsr_spacetime import SpacetimeBSRDecoder
    from .spacetime_bp import SpacetimeBPDecoder

    dev = resolve_device(device)
    H = sparse.csr_matrix(H)
    if stbsr_selected(TannerELL.from_check_matrix(H), num_rounds, dev):
        return SpacetimeBSRDecoder.from_check_matrix(H, num_rounds, device=dev, **opts)
    return SpacetimeBPDecoder.from_check_matrix(H, num_rounds, device=dev, **opts)


def qc_kwargs_for_code(code, sector: str = "z") -> Dict:
    """``make_bp_decoder`` QC kwargs for decoding a code's X or Z sector
    (empty dict when the code carries no block-circulant metadata)."""
    meta = getattr(code, "qc_meta", None)
    if meta is None:
        return {}
    return {
        "qc_dims": meta.dims,
        "qc_check_perm": meta.check_perm(sector),
        "qc_var_perm": meta.qubit_perm,
    }


def qc_kwargs_single_shot(code, sector: str = "z") -> Dict:
    """QC kwargs for the single-shot matrix (H|I) of a sector: the identity
    block stays block-circulant, so the measurement columns permute with
    the CHECK permutation."""
    meta = getattr(code, "qc_meta", None)
    if meta is None:
        return {}
    H = code.checks.z if sector == "z" else code.checks.x
    r, n = H.shape
    check_perm = meta.check_perm(sector)
    qperm = meta.qubit_perm
    if check_perm is None and qperm is None:
        var_perm = None
    else:
        cp = np.arange(r) if check_perm is None else check_perm
        qp = np.arange(n) if qperm is None else qperm
        var_perm = np.concatenate([qp, n + cp])
    return {
        "qc_dims": meta.dims,
        "qc_check_perm": check_perm,
        "qc_var_perm": var_perm,
    }
