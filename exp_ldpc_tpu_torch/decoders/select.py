"""Decoder selection: route each code to its kernel.

Counterpart of ``exp_ldpc_tpu/decoders/select.py``, with the JAX rules kept
as they are:

  * :func:`make_bp_decoder` (flat BP): from ~1 MiB of dense routing
    operands up, where "usable" (a CUDA device, the counterpart of the
    reference's TPU, and :func:`fits_bsr`, as ``_bsr_usable`` asks), kernel
    K1 (:class:`.bp_bsr.BSRBPDecoder`, early exit per shot block); else,
    with ``qc_dims`` given, the quasi-cyclic roll decoder
    (:class:`.qc_bp.QCBPDecoder`) where its monomial count and the operand
    size are in its range; else :class:`.bp.BPDecoder`.  The int8 message
    path (kernel K5) is passed through when asked for by
    ``msg_dtype="int8"`` and never chosen.
  * :func:`make_spacetime_bp_decoder`: from the same threshold up (and
    rounds >= 1) the K3 contract
    (:class:`.bp_bsr_spacetime.SpacetimeBSRDecoder`, global early exit)
    where usable (a CUDA device and :func:`fits_stbsr`, as
    ``_stbsr_usable`` asks), else the structured decoder
    (:class:`.spacetime_bp.SpacetimeBPDecoder`: K2 in fixed-iteration mode).

The thresholds and the fit rules were measured and sized on a TPU v5e;
re-deriving them on the H100 is a ROADMAP item.  The fit rules are kept
because they decide the decode's contract (bf16 messages and an early exit,
or f32 at fixed iterations): with them the port decodes every code as the
reference does.
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
           "fits_bsr", "fits_stbsr", "fits_stbsr_sched", "qc_kwargs_for_code",
           "qc_kwargs_single_shot"]

# exp_ldpc_tpu/decoders/select.py:45 (v5e crossover)
BSR_MIN_OPS_BYTES = 2**20
# exp_ldpc_tpu/decoders/select.py:31, :38 (the quasi-cyclic roll decoder's range)
_QC_MAX_MONOMIALS = 256
_QC_PREFER_DENSE_OPS_LIMIT = 4 * 2**20


_TILE = 128   # the reference's BSR tile (exp_ldpc_tpu/decoders/bp_bsr.py:66)


def _ops_bytes(tanner) -> int:
    return dense_ops_bytes(tanner.num_vars, tanner.num_checks, tanner.max_check_degree)


def _layout(tanner):
    """The port's ``BSRLayout`` of ``tanner`` (its tables on the CPU): the
    padded sizes and tile count the fit rules read."""
    from .bp_bsr import BSRLayout

    return BSRLayout.from_tanner(tanner, "cpu")


def fits_bsr(layout, shot_block: int = 128, vmem_budget_bytes: int = 64 * 2**20) -> bool:
    """The reference's routing rule for the flat K1 contract: its estimate
    of K1's TPU VMEM (``exp_ldpc_tpu/decoders/bp_bsr.py:201-218``: bf16
    messages, f32 posterior / parity / syndromes, the fused min-sum scan
    state, the one-hot tiles, the tables, temporaries) under a 64 MiB
    budget, computed on a :class:`.bp_bsr.BSRLayout`.  It is not an H100
    memory limit: the port keeps it so that the automatic choice gives each
    code the reference's decode contract."""
    sb = shot_block
    msg = 2 * layout.e_pad * sb
    state = 4 * sb * (layout.v_pad + 2 * layout.c_pad) + 16 * layout.c_pad * sb
    onehots = layout.num_tiles * _TILE * _TILE * 2
    tables = 4 * (layout.e_pad + 2 * layout.e_pad // _TILE * _TILE)
    temps = 4 * 8 * _TILE * sb
    return msg + state + onehots + tables + temps < vmem_budget_bytes


def fits_stbsr_sched(layout, shot_block: int = 128, vmem_budget_bytes: int = 100 * 2**20,
                     onehot_vmem: bool = True) -> bool:
    """The reference's per-call VMEM estimate of the streamed spacetime
    kernel K3 (``exp_ldpc_tpu/decoders/bp_bsr_spacetime.py:531-549``:
    double-buffered message, posterior, measurement and syndrome windows,
    three scratch panels, the optional one-hot store, temporaries) under a
    100 MiB budget, on a :class:`.bp_bsr.BSRLayout` of the base code.  A
    routing rule, not an H100 memory limit (see :func:`fits_bsr`)."""
    sb, c_pad = shot_block, layout.c_pad
    win = 2 * 2 * layout.e_pad * sb * 2 + 2 * 4 * layout.v_pad * sb
    win += 2 * (4 * 2 + 4) * c_pad * sb + 2 * 2 * c_pad * sb
    scratch = 3 * 4 * c_pad * sb
    oh = layout.num_tiles * _TILE * _TILE * 2 if onehot_vmem else 0
    temps = 4 * 8 * _TILE * sb
    return win + scratch + oh + temps < vmem_budget_bytes


def fits_stbsr(layout, num_rounds: int, shot_block: int = 128,
               vmem_budget_bytes: int = 100 * 2**20) -> bool:
    """``fits_stbsr_sched`` without the one-hot store
    (``exp_ldpc_tpu/decoders/bp_bsr_spacetime.py:552-559``): independent of
    the round count."""
    del num_rounds
    return fits_stbsr_sched(layout, shot_block, vmem_budget_bytes, onehot_vmem=False)


def bsr_selected(tanner, device: torch.device) -> bool:
    """True where the JAX rule picks the flat K1 contract: from 1 MiB of
    dense routing operands up, on a CUDA device, where :func:`fits_bsr`
    holds (``_bsr_usable``)."""
    return device.type == "cuda" and _ops_bytes(tanner) >= BSR_MIN_OPS_BYTES \
        and fits_bsr(_layout(tanner))


def stbsr_selected(tanner, num_rounds: int, device: torch.device) -> bool:
    """True where the JAX rule picks the streamed K3 contract: rounds >= 1,
    from 1 MiB of dense routing operands up, on a CUDA device, where
    :func:`fits_stbsr` holds (``_stbsr_usable``)."""
    return num_rounds >= 1 and device.type == "cuda" \
        and _ops_bytes(tanner) >= BSR_MIN_OPS_BYTES and fits_stbsr(_layout(tanner), 1)


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
