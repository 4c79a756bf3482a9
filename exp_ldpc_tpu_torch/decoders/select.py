"""Spacetime-decoder selection: route each code to its kernel.

Counterpart of ``make_spacetime_bp_decoder`` in
``exp_ldpc_tpu/decoders/select.py``, with the JAX rule kept as it is: from
~1 MiB of dense routing operands up (and rounds >= 1) the K3 contract
(:class:`.bp_bsr_spacetime.SpacetimeBSRDecoder`, global early exit), below
it the structured decoder (:class:`.spacetime_bp.SpacetimeBPDecoder`: K2
in fixed-iteration mode).  "Usable" for K3 means a CUDA device.  The
threshold was measured on a TPU v5e; re-deriving it on the H100 is a
ROADMAP item.
"""
from __future__ import annotations

import torch
from scipy import sparse

from .. import _host
from ..utils.device import DeviceLike, resolve_device
from .bp import dense_ops_bytes

__all__ = ["make_spacetime_bp_decoder", "stbsr_selected"]

# exp_ldpc_tpu/decoders/select.py:45 (v5e crossover)
BSR_MIN_OPS_BYTES = 2**20


def stbsr_selected(tanner, num_rounds: int, device: torch.device) -> bool:
    """True where the JAX rule picks the streamed K3 contract."""
    ops = dense_ops_bytes(tanner.num_vars, tanner.num_checks, tanner.max_check_degree)
    return num_rounds >= 1 and ops >= BSR_MIN_OPS_BYTES and device.type == "cuda"


def make_spacetime_bp_decoder(H, num_rounds: int, *, device: DeviceLike = "cuda", **opts):
    """Multi-round spacetime BP on ``device`` with automatic kernel choice;
    ``H`` is the BASE check matrix."""
    from .bp_bsr_spacetime import SpacetimeBSRDecoder
    from .spacetime_bp import SpacetimeBPDecoder

    dev = resolve_device(device)
    H = sparse.csr_matrix(H)
    if stbsr_selected(_host.TannerELL.from_check_matrix(H), num_rounds, dev):
        return SpacetimeBSRDecoder.from_check_matrix(H, num_rounds, device=dev, **opts)
    return SpacetimeBPDecoder.from_check_matrix(H, num_rounds, device=dev, **opts)
