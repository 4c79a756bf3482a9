"""Decoder selection: route each code to its fastest decoder on the card.

Counterpart of ``exp_ldpc_tpu/decoders/select.py``.  The JAX module chooses
among its decoders by measurements of a TPU v5e (a 1 MiB dense-operand
crossover, ``artifacts/bp_families_v5e.jsonl``) and by the TPU's VMEM
(``fits_bsr``, ``fits_stbsr``).  This module chooses among the same
decoders, each with the contract it has in the JAX package, by
measurements of the H100 (``artifacts/select_h100.jsonl``, written by
:mod:`..experiments.bench_select`: every candidate of each selection point
timed on the same inputs at its callers' codes and shot counts, NVIDIA
H100 80GB HBM3 at 700 W).

On the CPU the choice is the JAX package's on a CPU, where its TPU kernels
do not run: :class:`.bp.BPDecoder` (per-shot freezing, or fixed iterations
as asked), or the quasi-cyclic roll decoder (:class:`.qc_bp.QCBPDecoder`)
where ``qc_dims`` is given, the monomial count is at most 256 and the dense
routing operands pass 4 MiB; spacetime BP is
:class:`.spacetime_bp.SpacetimeBPDecoder`.

On a CUDA device the caller's ``early_stop`` picks the contract, as it does
in the JAX package, and the code's shape picks the decoder that has it:

  * an early-stop call gets a decoder with an exit: kernel K1
    (:class:`.bp_bsr.BSRBPDecoder`: bf16 messages, f32 sums, the exit per
    shot block) for flat BP, kernel K3
    (:class:`.bp_bsr_spacetime.SpacetimeBSRDecoder`: bf16, one exit for the
    batch) for spacetime BP.  The other decoders with an exit, the
    per-shot-freezing cores and the roll decoder, are plain PyTorch on the
    card and slower at every early-stop row (1.2-78x);
  * a fixed-iteration call (:func:`make_bp_decoder`): kernel K6
    (``BPDecoder`` at fixed iterations, f32) where at least
    :data:`K6_MIN_SHOTS` shots of it fit one block's shared memory
    (:func:`k6_shots`), or where K6 takes its streamed route by its own
    rule (1 or 2 shots of checks of 17 slots or more would fit a block:
    ``bp_cuda.STREAMED_MAX_FIT``, ``STREAMED_MIN_WIDTH``), else K1 with the
    exit unarmed;
    :func:`make_spacetime_bp_decoder` (rounds >= 1): kernel K2
    (``SpacetimeBPDecoder`` at fixed iterations, f32) where one shot of it
    fits (:func:`k2_shots`), else K3 unarmed.  No rounds:
    ``SpacetimeBPDecoder`` as asked;
  * ``msg_dtype="int8"`` names kernel K5 (``BSRBPDecoder``'s int8 path, an
    ablation): built where asked, never chosen otherwise.

K6 and K2 have no exit: the JAX package never returns them for an
early-stop call (its ``BPDecoder`` with the exit is the per-shot core), and
neither does this rule.  The rule sees no data, and the exit's worth
depends on it: on a batch that converges in a few iterations K1's armed
exit beats K6 up to 5x (qclp_1054_140 at 16,384 shots, rows 163-166), on
one where some shot of every block runs to the last iteration (the host
BP+OSD redecode of the shots the device step left unconverged: rows
``*_hard``, 281-284 and 325-328) the fixed K6 and K2 are 2-3.5x faster
than the armed K1 and K3.  The caller's request decides; the pipeline's
device step asks fixed iterations.  ``fits_bsr``, ``fits_stbsr`` and
``fits_stbsr_sched`` keep the JAX package's VMEM arithmetic; the choice
does not ask them.
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional

import numpy as np
import torch
from scipy import sparse

from ..utils.cuda_build import resident_fit
from ..utils.device import DeviceLike, resolve_device
from .bp import dense_ops_bytes
from .bp_cuda import resident_bytes as k6_resident_bytes
from .bp_cuda import streams as k6_streams
from .spacetime_bp_cuda import resident_bytes as k2_resident_bytes
from .tanner import TannerELL

__all__ = ["make_bp_decoder", "make_spacetime_bp_decoder", "flat_choice", "spacetime_choice",
           "k6_shots", "k2_shots", "smem_optin", "K6_MIN_SHOTS", "H100_SMEM_OPTIN", "fits_bsr", "fits_stbsr", "fits_stbsr_sched",
           "qc_kwargs_for_code", "qc_kwargs_single_shot"]

# The JAX package's CPU rule (exp_ldpc_tpu/decoders/select.py:31, :38): the
# roll decoder's monomial range and its operand floor.  The port's CPU choice
# is the JAX package's, so these stay as they are; on the card the roll
# decoder is plain PyTorch and never chosen.
_QC_MAX_MONOMIALS = 256
_QC_PREFER_DENSE_OPS_LIMIT = 4 * 2**20

# Opt-in shared memory per block of the H100, in bytes: the limit K2's and
# K6's launch plans read from the card (cudaDevAttrMaxSharedMemoryPerBlockOptin;
# "smem_optin" in every row of artifacts/select_h100.jsonl).  A code whose one
# shot fits runs their resident route.  The rule reads the card's own value
# where a card is behind the device (smem_optin); this one stands for a device
# object with none.
H100_SMEM_OPTIN = 232448

# K6 against K1 at fixed iterations (artifacts/select_h100.jsonl, flat rows,
# request "fixed", 685 / 1,024 / 2,048 / 16,384 shots x 48): K6 is ahead by
# 9-20% at three of four shot counts where 8 shots fit a block (hgp_1600; 14%
# behind at 2,048), by 1.0-3.4x from 12 shots up (qclp_1054_140, hgp_625,
# hgp_400, hgp225_HI, hgp_225, gross_144_12_12; ties for qclp_1054_140 at
# 2,048 shots and the two smallest HGP matrices at 16,384: rows 78/80 and
# 246/248, within 3%, where another run on the same card may put K1 ahead by
# ~10-15%, as chip_smoke.py's K1 and K6 timings at (H|I) 16,384 x 48 do;
# the rule cannot see the shot count); with 5 (hgp_2025:
# 9-24% behind at two counts, 12-14% ahead at two), 2 (dem_1r: 25-42% behind
# from 1,024 shots) and 1 (cyclic_lp_4862, hgp_10000: 15-60% behind) K1
# leads.  K2 resident against K3 (spacetime rows, "fixed"): K2 ahead at every
# shape where one shot fits, down to one shot a block (hgp_1600 x4: 4.88 vs
# 7.12 ms at 685 shots, 98.9 vs 129.4 at 16,384; hgp_625 x4 at 4 shots: 2.27
# vs 2.36, 42.3 vs 51.4), and 9-136x behind on the streamed route as it was
# (cyclic_lp_4862 x4 and x8, hgp_10000 x8, hgp_15625 x4).  The streamed route
# as device-memory grids (rows 329-346) still trails K3 there (1.3-1.4x at the
# cyclic code, 1.4x at hgp_10000 x8 and hgp_15625 x4) and K1 where one
# shot does not fit (hgp_15625, hgp_40000: 1.6-1.8x; dem_4r), but where
# K6's own rule streams, 1 or 2 shots of wide checks a block, it leads K1
# at three of four counts (rows 347-370: cyclic_lp_4862, 24 slots, 1 shot:
# 12.7 / 23.6 / 174.1 vs 15.1 / 25.9 / 187.5 ms at 1,024 / 2,048 / 16,384,
# 4% behind at 685; dem_1r, 53 slots, 2 shots: 2.23 / 2.60 / 5.62 vs 2.95 /
# 2.87 / 6.23 at 685 / 1,024 / 2,048, 15% behind at 16,384, which the rule,
# blind to the shot count, does not see), and 1.4-4.3x ahead at the 18- and
# 20-slot probes (rows 371-430: hgp_2880_w18, hgp_4500_w18, hgp_3200_w20,
# 685-16,384 shots), where K1 leads the resident K6 at the 12-slot ones
# (1.01-1.43x: hgp_4500_w12, hgp_8000_w12).
K6_MIN_SHOTS = 8

_TILE = 128   # the reference's BSR tile (exp_ldpc_tpu/decoders/bp_bsr.py:66)


def _ops_bytes(tanner) -> int:
    return dense_ops_bytes(tanner.num_vars, tanner.num_checks, tanner.max_check_degree)


def fits_bsr(layout, shot_block: int = 128, vmem_budget_bytes: int = 64 * 2**20) -> bool:
    """The JAX package's estimate of K1's TPU VMEM
    (``exp_ldpc_tpu/decoders/bp_bsr.py:201-218``: bf16 messages, f32
    posterior / parity / syndromes, the fused min-sum scan state, the one-hot
    tiles, the tables, temporaries) under a 64 MiB budget, computed on a
    :class:`.bp_bsr.BSRLayout`.  A TPU layout rule: the port's choice does
    not ask it."""
    sb = shot_block
    msg = 2 * layout.e_pad * sb
    state = 4 * sb * (layout.v_pad + 2 * layout.c_pad) + 16 * layout.c_pad * sb
    onehots = layout.num_tiles * _TILE * _TILE * 2
    tables = 4 * (layout.e_pad + 2 * layout.e_pad // _TILE * _TILE)
    temps = 4 * 8 * _TILE * sb
    return msg + state + onehots + tables + temps < vmem_budget_bytes


def fits_stbsr_sched(layout, shot_block: int = 128, vmem_budget_bytes: int = 100 * 2**20,
                     onehot_vmem: bool = True) -> bool:
    """The JAX package's per-call VMEM estimate of the streamed spacetime
    kernel K3 (``exp_ldpc_tpu/decoders/bp_bsr_spacetime.py:531-549``:
    double-buffered message, posterior, measurement and syndrome windows,
    three scratch panels, the optional one-hot store, temporaries) under a
    100 MiB budget, on a :class:`.bp_bsr.BSRLayout` of the base code.  A TPU
    layout rule (see :func:`fits_bsr`)."""
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


def smem_optin(device: torch.device) -> int:
    """Opt-in shared memory per block of ``device`` in bytes: the card's own
    where a card is behind the device, else :data:`H100_SMEM_OPTIN`."""
    if device.type == "cuda" and torch.cuda.is_available():
        props = torch.cuda.get_device_properties(device)
        return int(getattr(props, "shared_memory_per_block_optin", H100_SMEM_OPTIN))
    return H100_SMEM_OPTIN


def _block_shots(per_shot: int, fixed: int, tables: int, budget: int) -> int:
    """Shots of one resident block in ``budget`` bytes of shared memory at
    one block per SM, as the launch plans fit them; 0 where one shot does
    not fit (the streamed route)."""
    if per_shot + fixed > budget:
        return 0
    return resident_fit(per_shot, tables, budget, fixed)[1]


def k6_shots(tanner, smem: int = H100_SMEM_OPTIN) -> int:
    """Shots of K6 that fit one block's ``smem`` bytes of shared memory
    (``bp_cuda.resident_bytes``; 0: the streamed route)."""
    return _block_shots(*k6_resident_bytes(tanner), smem)


def k2_shots(tanner, num_rounds: int, smem: int = H100_SMEM_OPTIN) -> int:
    """Shots of K2 over ``num_rounds`` rounds that fit one block's ``smem``
    bytes of shared memory (``spacetime_bp_cuda.resident_bytes``)."""
    return _block_shots(*k2_resident_bytes(tanner, num_rounds), smem)


def flat_choice(tanner, device: torch.device, *, early_stop: bool = True,
                msg_dtype: str = "bfloat16", qc_monomials: Optional[int] = None) -> str:
    """The flat decoder for ``tanner`` on ``device``: "K1"
    (``BSRBPDecoder``, the exit as asked), "K6" (``BPDecoder`` at fixed
    iterations: kernel K6 on the card, its plain version on the CPU),
    "bp_core" (``BPDecoder`` with per-shot freezing) or "qc"
    (``QCBPDecoder``; ``qc_monomials`` is the code's monomial count where
    ``qc_dims`` is given).  Each is built with the caller's ``early_stop``."""
    if device.type != "cuda":
        if qc_monomials is not None and qc_monomials <= _QC_MAX_MONOMIALS \
                and _ops_bytes(tanner) > _QC_PREFER_DENSE_OPS_LIMIT:
            return "qc"
        return "bp_core" if early_stop else "K6"
    if msg_dtype == "int8" or early_stop:
        return "K1"
    smem = smem_optin(device)
    shots = k6_shots(tanner, smem)
    # where one shot fits yet K6 streams by its own rule (wide checks, 1-2 shots a block)
    return "K6" if shots >= K6_MIN_SHOTS or (shots >= 1 and k6_streams(tanner, smem)) else "K1"


def spacetime_choice(tanner, num_rounds: int, device: torch.device, *,
                     early_stop: bool = True) -> str:
    """The spacetime decoder for the base code ``tanner`` over ``num_rounds``
    rounds on ``device``: "K3" (``SpacetimeBSRDecoder``, the exit as asked),
    "K2" (``SpacetimeBPDecoder`` at fixed iterations) or "stbp_core"
    (``SpacetimeBPDecoder`` with per-shot freezing)."""
    if device.type != "cuda" or num_rounds < 1:
        return "stbp_core" if early_stop else "K2"
    if early_stop:
        return "K3"
    return "K2" if k2_shots(tanner, num_rounds, smem_optin(device)) > 0 else "K3"


def make_bp_decoder(H, *, qc_dims=None, qc_check_perm=None, qc_var_perm=None,
                    device: DeviceLike = "cuda", **opts):
    """Flat BP on ``device``, the decoder :func:`flat_choice` names.
    ``opts`` are the decoders' ``from_check_matrix`` options; the BSR-only
    ``shot_block``, ``msg_dtype`` and ``prior_quanta`` are dropped where
    another decoder is chosen (as JAX ignores them there).

    ``msg_dtype="int8"`` (kernel K5 on the card) is an ablation: it is built
    where asked for and never chosen."""
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
    monomials = None if qc_dims is None else H.nnz // int(np.prod(qc_dims))
    choice = flat_choice(tanner, dev, early_stop=opts.get("early_stop", True),
                         msg_dtype=opts.get("msg_dtype", "bfloat16"), qc_monomials=monomials)
    if choice == "K1":
        return BSRBPDecoder.from_check_matrix(H, check_perm=qc_check_perm, var_perm=qc_var_perm,
                                              device=dev, **opts)
    opts = {k: v for k, v in opts.items()
            if k not in ("shot_block", "msg_dtype", "prior_quanta")}
    if choice == "qc":
        return QCBPDecoder.from_check_matrix(H, qc_dims, check_perm=qc_check_perm,
                                             var_perm=qc_var_perm, device=dev, **opts)
    return BPDecoder.from_check_matrix(H, device=dev, **opts)


def make_spacetime_bp_decoder(H, num_rounds: int, *, device: DeviceLike = "cuda", **opts):
    """Multi-round spacetime BP on ``device``, the decoder
    :func:`spacetime_choice` names; ``H`` is the BASE check matrix."""
    from .bp_bsr_spacetime import SpacetimeBSRDecoder
    from .spacetime_bp import SpacetimeBPDecoder

    dev = resolve_device(device)
    H = sparse.csr_matrix(H)
    choice = spacetime_choice(TannerELL.from_check_matrix(H), num_rounds, dev,
                              early_stop=opts.get("early_stop", True))
    if choice == "K3":
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
