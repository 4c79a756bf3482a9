"""Kernel K8: the OSD step of BP+OSD on the card, one block per shot.

Replaces no TPU kernel: the JAX package runs OSD on the host, in the
threaded C++ of ``native/gf2_kernels.cpp::osd_batch``
(:func:`.osd.osd_decode_batch`), which is this kernel's plain version and
gives the same answer bit for bit (``csrc/osd.cu`` states the contract; the
one licence is a pair of candidates whose costs tie to the last bits, where
CUDA's and glibc's ``exp`` / ``log`` may round apart).  The CUDA source is
``csrc/osd.cu``; its header says what bounds it on an H100 and how the
design answers that.

K8 has two routes.  "block": a block a shot, the packed matrix in the
block's shared memory.  "device": where that does not fit, the matrix in a
block's slot of device memory (one slot a block in flight, so that they
stay in L2), a block taking shots in turn (:func:`device_plan`).
:func:`route` is the route rule, a pure function of what the caller can
observe: a CUDA device, at most :data:`MAX_ROWS` checks, a method and order
the kernel takes, and the card's opt-in shared memory a block.  The block
route wherever the packed matrix fits a block, else the device route where
its per-row state does, else none: everything else stays on the C++ path.
The ordered columns come from :func:`reliability_order`; :func:`card_matrix`
puts H's columns on the card once per decoder; :func:`osd_solve` checks its
tensors and launches.  ``KERNEL.launches`` and ``DEVICE_KERNEL.launches``
count launches of each route (one per redecode call with unconverged
shots).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch
from scipy import sparse

from ..utils.cuda_build import CudaKernel, device_limits

__all__ = ["KERNEL", "DEVICE_KERNEL", "METHODS", "MAX_ROWS", "MAX_COLS", "MAX_ORDER",
           "OSD_E_MAX_ORDER", "CardMatrix", "card_matrix", "smem_bytes", "threads",
           "DevicePlan", "device_smem_bytes", "device_plan", "route", "takes", "card_route",
           "order_keys", "reliability_order", "osd_solve"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# csrc/osd.cu::osd_solve: colptr, rowidx, order, llr, synd; S, r, n, method, order, threads,
# smem_bytes; out, the stream
KERNEL = CudaKernel("osd.cu", "osd_solve", [_P] * 5 + [_I] * 7 + [_P, _P])
# csrc/osd.cu::osd_device_solve: the same, with the grid's blocks before threads and
# smem_bytes, and the scratch of their slots before out
DEVICE_KERNEL = CudaKernel("osd.cu", "osd_device_solve", [_P] * 5 + [_I] * 8 + [_P] * 3)
METHODS = {"osd0": 0, "osd_e": 1, "osd_cs": 2}
MAX_ROWS = 1024        # a thread a row, a block of at most 1,024 threads
MAX_COLS = 65535       # the non-pivot columns are held as uint16
MAX_ORDER = 62         # osd_batch's own limit (past it the numpy path runs)
OSD_E_MAX_ORDER = 10   # osd_e scores 2^order candidates, a thread each in turn
_INT64_MAX = (1 << 63) - 1


class CardMatrix(NamedTuple):
    """H's columns on the card (entries mod 2, as ``osd_batch`` reads
    them): ``colptr`` (n + 1,) and ``rowidx`` (nnz,) int32."""

    colptr: torch.Tensor
    rowidx: torch.Tensor
    rows: int
    cols: int


def card_matrix(H, device: torch.device) -> CardMatrix:
    """:class:`CardMatrix` of ``H`` (sparse or dense 0/1) on ``device``."""
    dense = sparse.csr_matrix(H).toarray().astype(np.uint8) % 2
    csc = sparse.csc_matrix(dense)
    csc.sort_indices()
    r, n = dense.shape
    return CardMatrix(torch.as_tensor(csc.indptr.astype(np.int32)).to(device),
                      torch.as_tensor(csc.indices.astype(np.int32)).to(device), r, n)


def smem_bytes(r: int, n: int) -> int:
    """A block's dynamic shared memory (``csrc/osd.cu::layout``): per row a
    double cost, a uint16 and ``stride`` words of the packed [H | s] (the
    words of n + 1 bits, made odd); per column the mask bit and a uint16;
    640 bytes of reduction scratch."""
    stride = ((n + 1 + 31) // 32) | 1
    return 8 * r + 640 + 4 * r * stride + 4 * ((n + 31) // 32) + 2 * r + 2 * n


def threads(r: int) -> int:
    """Threads a block: one a row, rounded up to whole warps."""
    return 32 * (-(-r // 32))


class DevicePlan(NamedTuple):
    """A device-route launch: ``blocks`` blocks of ``threads`` threads (one a
    row) and ``smem_bytes`` of dynamic shared memory, each with a slot of
    ``slot_words`` 32-bit words of scratch for its matrix."""

    blocks: int
    threads: int
    smem_bytes: int
    slot_words: int


def device_smem_bytes(r: int, n: int) -> int:
    """A block's dynamic shared memory on the device route
    (``csrc/osd.cu::layout`` without the matrix): :func:`smem_bytes` less it."""
    return 8 * r + 640 + 4 * ((n + 31) // 32) + 2 * r + 2 * n


def device_plan(S: int, r: int, n: int, sm_count: int) -> DevicePlan:
    """One block an SM (a thread a row, up to 1,024 threads at 64
    registers: one block fills an SM's registers), at most ``S``; a slot of
    r rows of the packed [H | s] in ``stride`` words each."""
    stride = ((n + 1 + 31) // 32) | 1
    return DevicePlan(max(1, min(S, sm_count)), threads(r), device_smem_bytes(r, n), r * stride)


def route(device_type: str, r: int, n: int, method: str, order: int,
          smem_optin: int) -> Optional[str]:
    """K8's route for an OSD call, or None for the C++ path: the BP stage's
    device is CUDA; 1 <= r <= :data:`MAX_ROWS` and 1 <= n <=
    :data:`MAX_COLS`; the method is osd0 or osd_cs, or osd_e of order at
    most :data:`OSD_E_MAX_ORDER`; and 0 <= order <= :data:`MAX_ORDER`,
    where ``osd_batch`` takes it too.  Then "block" where the packed matrix
    fits ``smem_optin`` bytes (the card's opt-in shared memory a block),
    else "device" where the per-row state does (:func:`device_smem_bytes`)."""
    if not (device_type == "cuda" and 1 <= r <= MAX_ROWS and 1 <= n <= MAX_COLS
            and method in METHODS and 0 <= order <= MAX_ORDER
            and (method != "osd_e" or order <= OSD_E_MAX_ORDER)):
        return None
    if smem_bytes(r, n) <= smem_optin:
        return "block"
    return "device" if device_smem_bytes(r, n) <= smem_optin else None


def takes(device_type: str, r: int, n: int, method: str, order: int, smem_optin: int) -> bool:
    """Whether K8 serves an OSD call on either route (:func:`route`)."""
    return route(device_type, r, n, method, order, smem_optin) is not None


def card_route(H_shape, method: str, order: int, device: torch.device) -> Optional[str]:
    """:func:`route` on ``device``, whose opt-in shared memory comes from the
    card (building K8 on first use)."""
    if device.type != "cuda":
        return None
    smem, _sms = device_limits(KERNEL, device)
    return route(device.type, H_shape[0], H_shape[1], method, order, smem)


def order_keys(llr: torch.Tensor) -> torch.Tensor:
    """int64 keys of float64 LLRs whose ascending stable sort is numpy's
    stable argsort of the LLRs: order-preserving bits, -0.0 as +0.0 (a radix
    sort would put -0.0 first), every NaN after +inf."""
    x = llr + 0.0
    bits = x.view(torch.int64)
    keys = torch.where(bits < 0, bits ^ _INT64_MAX, bits)
    return torch.where(torch.isnan(x), torch.full_like(keys, _INT64_MAX), keys)


def reliability_order(llr: torch.Tensor) -> torch.Tensor:
    """(S, n) float64 LLRs -> (S, n) int32: each row's columns, most likely
    in error first (``osd_one_shot``'s order)."""
    return torch.sort(order_keys(llr), dim=1, stable=True).indices.to(torch.int32)


def osd_solve(mat: CardMatrix, syndromes: torch.Tensor, llr: torch.Tensor, method: str,
              order: int) -> torch.Tensor:
    """OSD of S shots on the card: syndromes (S, r) uint8, llr (S, n)
    float64 (the BP posteriors), both contiguous on ``mat``'s CUDA device
    -> (S, n) uint8, ``osd_decode_batch``'s answer.  The plain version is
    :func:`.osd.osd_decode_batch`; this raises for anything K8 does not take
    (a CPU tensor included)."""
    r, n = mat.rows, mat.cols
    dev = mat.colptr.device
    for name, t, dtype, width in (("syndromes", syndromes, torch.uint8, r),
                                  ("llr", llr, torch.float64, n)):
        if t.dtype != dtype:
            raise ValueError(f"osd_solve: {name} must be {dtype}, not {t.dtype}")
        if t.dim() != 2 or t.shape[1] != width:
            raise ValueError(f"osd_solve: {name} must have shape (S, {width}), "
                             f"not {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"osd_solve: {name} must be contiguous")
    S = syndromes.shape[0]
    if llr.shape[0] != S:
        raise ValueError(f"osd_solve: {S} syndromes but {llr.shape[0]} LLR rows")
    if dev.type != "cuda" or syndromes.device != dev or llr.device != dev:
        raise ValueError(f"osd_solve: syndromes on {syndromes.device}, llr on {llr.device}, the "
                         f"matrix on {dev}; K8 runs on a CUDA device (the host path is "
                         "osd_decode_batch)")
    smem, sms = device_limits(KERNEL, dev)
    way = route(dev.type, r, n, method, order, smem)
    if way is None:
        raise ValueError(f"osd_solve: K8 does not take {method} order {order} at {r} x {n} "
                         f"({device_smem_bytes(r, n)} B of {smem} B shared memory a block)")
    out = torch.empty((S, n), dtype=torch.uint8, device=dev)
    if S == 0:
        return out
    ordered = reliability_order(llr)
    args = (mat.colptr.data_ptr(), mat.rowidx.data_ptr(), ordered.data_ptr(), llr.data_ptr(),
            syndromes.data_ptr(), S, r, n, METHODS[method], int(order))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if way == "block":
        KERNEL.launch(*args, threads(r), smem_bytes(r, n), out.data_ptr(), stream)
    else:
        plan = device_plan(S, r, n, sms)
        scratch = torch.empty(plan.blocks * plan.slot_words, dtype=torch.int32, device=dev)
        DEVICE_KERNEL.launch(*args, plan.blocks, plan.threads, plan.smem_bytes,
                             scratch.data_ptr(), out.data_ptr(), stream, route="device")
    return out
