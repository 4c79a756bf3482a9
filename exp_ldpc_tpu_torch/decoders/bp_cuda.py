"""Kernel K6: fixed-iteration flat BP in f32 as one CUDA launch.

Replaces ``exp_ldpc_tpu/decoders/bp_pallas.py::_kernel`` (the VMEM-resident
Pallas kernel, launched by ``bp_pallas_fixed``).  The CUDA source is
``csrc/bpflat.cu``; its header says what bounds it on an H100 and how the
design answers that.  The plain version is :func:`.bp.bp_core` with
``early_stop=False``: its contract is the flat BP stage that the pipeline's
single-shot and hybrid modes run on the device.

The kernel has two routes, picked by :func:`launch_plan` from the shape
before the launch (never after a failure): "resident" keeps every message
of a block's shots in shared memory for the whole decode; "streamed" (one
shot's state exceeds the card's opt-in shared memory, e.g. the n = 40,000
HGP) keeps them in device memory.  Checks of more than ``MAX_SLOTS`` (32)
slots take route "wide" on either route (a two-pass check phase), which the
plan sets from the degree.  ``KERNEL.launches`` counts decodes,
``KERNEL.routes`` splits the count by route (``ResidentPlan.label``).

:func:`bp_fixed` takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import logging
from typing import Optional, Tuple

import torch

from ..convert import TannerTables
from ..utils.cuda_build import (MAX_SLOTS, CudaKernel, ResidentPlan, device_limits,
                                resident_plan, streamed_plan)
from .bp import bp_core, normalize_method

__all__ = ["bp_fixed", "launch_plan", "resident_bytes", "streamed_scratch", "KERNEL"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = CudaKernel("bpflat.cu", "bp_fixed", [_P] * 7 + [_I] * 7 + [_F] + [_I] * 6 + [_P])
_log = logging.getLogger(__name__)
# Blocks side by side per SM at batches past one wave: the winner of
# experiments/bench_resident.py's sweep at (H|I) 16,384 x 48 (PERF.md §6).
BLOCKS_PER_SM = 1


def streamed_scratch(tables: TannerTables) -> Tuple[Tuple[str, int], ...]:
    """Rows of the streamed route's f32 device-memory scratch, each (row, S):
    the messages."""
    return (("msg", tables.num_checks * tables.max_check_degree),)


def resident_bytes(tables: TannerTables) -> Tuple[int, int, int]:
    """(bytes per shot, fixed bytes, table bytes) of a resident block's
    shared memory (``csrc/bpflat.cu::bp_resident_bytes``): per shot every
    f32 message, its syndrome bytes and a flag; fixed, each check's
    live-slot mask; the two Tanner tables (int32)."""
    C, V, Dc, Dv = (tables.num_checks, tables.num_vars, tables.max_check_degree,
                    tables.max_var_degree)
    return 4 * (C * Dc + 1) + C, 4 * C, 4 * (C * Dc + V * Dv)


def launch_plan(tables: TannerTables, shots: int, device: torch.device, route: str = "auto",
                **tune) -> ResidentPlan:
    """The route and launch of one decode of ``shots`` shots on ``device``
    (``tune``: ``resident_plan``'s ``blocks_per_sm`` (default
    :data:`BLOCKS_PER_SM`), ``threads``, ``max_group``, ``pad``).  The
    streamed kernel reads its tables through the read-only cache and takes
    no dynamic shared memory.  ``route="streamed"`` forces the streamed
    route (before/after measurements in one run).  Checks of more than
    ``MAX_SLOTS`` slots set ``wide`` (route "wide") on either route."""
    smem, sms = device_limits(KERNEL, device)
    per_shot, fixed, table = resident_bytes(tables)
    if route not in ("auto", "streamed"):
        raise ValueError(f"unknown route {route!r}")
    tune.setdefault("blocks_per_sm", BLOCKS_PER_SM)
    plan = (streamed_plan(shots, table, smem) if route == "streamed" else
            resident_plan(per_shot, table, shots, smem, sms, fixed_bytes=fixed,
                          width=tables.max_check_degree, **tune))
    if plan.route == "streamed":   # its tables are read through the read-only cache
        plan = plan._replace(tables_smem=False, smem_bytes=0)
    return plan._replace(wide=tables.max_check_degree > MAX_SLOTS)


def bp_fixed(tables: TannerTables, prior_llr: torch.Tensor, syndromes: torch.Tensor,
             method: str, max_iter: int, ms_scaling_factor: float,
             plan: Optional[ResidentPlan] = None):
    """Same interface and outputs as ``bp_core(..., early_stop=False)``:
    prior_llr (V,) f32, syndromes (C, S) 0/1 -> (hard (V, S) uint8,
    posterior (V, S) f32, converged (S,) bool, iters (S,) int32).
    ``plan`` overrides :func:`launch_plan` (the benchmarks' sweeps)."""
    method = normalize_method(method)
    if syndromes.device.type == "cpu":
        return bp_core(tables, prior_llr, syndromes, method, max_iter, ms_scaling_factor,
                       early_stop=False)
    if syndromes.device.type != "cuda":
        raise ValueError(f"bp_fixed: unsupported device {syndromes.device}")
    dev = syndromes.device
    t = tables
    C, V, Dc, Dv = t.num_checks, t.num_vars, t.max_check_degree, t.max_var_degree
    Cs, S = syndromes.shape
    if Cs != C:
        raise ValueError(f"syndromes have {Cs} rows, expected {C}")
    if t.device != dev or prior_llr.device != dev:
        raise ValueError("bp_fixed: tables, priors and syndromes must share one device")
    prior = prior_llr.to(torch.float32).contiguous()
    if prior.shape != (V,):
        raise ValueError(f"prior_llr must have shape ({V},)")
    if S == 0:  # a grid of no blocks is not a launch
        return (torch.empty((V, 0), dtype=torch.uint8, device=dev),
                torch.empty((V, 0), dtype=torch.float32, device=dev),
                torch.empty((0,), dtype=torch.bool, device=dev),
                torch.empty((0,), dtype=torch.int32, device=dev))
    if max_iter < 0:
        raise ValueError(f"max_iter must be >= 0, got {max_iter}")
    plan = plan or launch_plan(t, S, dev)
    synd = syndromes.to(torch.uint8).contiguous()
    msg = (torch.empty((streamed_scratch(t)[0][1], S), dtype=torch.float32, device=dev)
           if plan.route == "streamed" else None)
    post = torch.empty((V, S), dtype=torch.float32, device=dev)
    conv = torch.empty((S,), dtype=torch.uint8, device=dev)
    (_log.info if plan.route == "streamed" else _log.debug)(
        "K6 %s route: %d shots, C=%d V=%d, %s", plan.label, S, C, V, plan)
    KERNEL.launch(
        synd.data_ptr(), prior.data_ptr(), t.chk_vars_k.data_ptr(), t.vm_k.data_ptr(),
        0 if msg is None else msg.data_ptr(), post.data_ptr(), conv.data_ptr(),
        C, V, Dc, Dv, S, int(max_iter), 0 if method == "ps" else 1, float(ms_scaling_factor),
        plan.group, plan.stride, plan.threads, int(plan.tables_smem), plan.smem_bytes,
        int(plan.wide), torch.cuda.current_stream(dev).cuda_stream, route=plan.label)
    hard = (post <= 0).to(torch.uint8)
    iters = torch.full((S,), int(max_iter), dtype=torch.int32, device=dev)
    return hard, post, conv.bool(), iters
