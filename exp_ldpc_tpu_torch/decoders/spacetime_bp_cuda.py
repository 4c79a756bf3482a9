"""Kernel K2: fixed-iteration structured spacetime BP as one CUDA launch.

Replaces ``exp_ldpc_tpu/decoders/spacetime_bp_pallas.py::_kernel`` (the
VMEM-resident Pallas kernel, launched by ``stbp_pallas_fixed``).  The CUDA
source is ``csrc/stbp.cu``; its header says what bounds it on an H100 and
how the design answers that.  The plain version is
:func:`.spacetime_bp.stbp_core` with ``early_stop=False``.

The kernel has two routes, picked by :func:`launch_plan` from the shape
before the launch (never after a failure): "resident" keeps every message
of a block's shots in shared memory for the whole decode; "streamed" (one
shot's state exceeds the card's opt-in shared memory) keeps them in device
memory.  Checks of more than ``MAX_SLOTS`` (32) slots, data and
measurement slots together, take route "wide" on either route (a two-pass
check phase), which the plan sets from the degree.  ``KERNEL.launches``
counts decodes, ``KERNEL.routes`` splits the count by route
(``ResidentPlan.label``).

:func:`stbp_fixed` takes the plain version only for CPU tensors; for CUDA
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
from .bp import normalize_method
from .spacetime_bp import stbp_core

__all__ = ["stbp_fixed", "launch_plan", "resident_bytes", "streamed_scratch", "KERNEL"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = CudaKernel("stbp.cu", "stbp_fixed",
                    [_P] * 9 + [_I] * 8 + [_F] + [_I] * 6 + [_P])
_log = logging.getLogger(__name__)
# Blocks side by side per SM at batches past one wave: the winner of
# experiments/bench_resident.py's sweep at HGP-225 16,384 x 48 (PERF.md §6).
BLOCKS_PER_SM = 4


def streamed_scratch(tables: TannerTables, num_rounds: int) -> Tuple[Tuple[str, int], ...]:
    """Rows of the streamed route's f32 device-memory scratch, each (row, S):
    the data messages and the two measurement message arrays."""
    R, r = int(num_rounds), tables.num_checks
    return (("msg", (R + 1) * r * tables.max_check_degree), ("mlo", max(R * r, 1)),
            ("mhi", max(R * r, 1)))


def resident_bytes(tables: TannerTables, num_rounds: int) -> Tuple[int, int, int]:
    """(bytes per shot, fixed bytes, table bytes) of a resident block's
    shared memory (``csrc/stbp.cu::stbp_resident_bytes``): per shot every
    f32 message, its syndrome bytes and a flag; fixed, each base check's
    live-slot mask; the two Tanner tables (int32)."""
    R, B = int(num_rounds), int(num_rounds) + 1
    r, n, Dc, Dv = (tables.num_checks, tables.num_vars, tables.max_check_degree,
                    tables.max_var_degree)
    return 4 * (B * r * Dc + 2 * R * r + 1) + B * r, 4 * r, 4 * (r * Dc + n * Dv)


def launch_plan(tables: TannerTables, num_rounds: int, shots: int, device: torch.device,
                route: str = "auto", **tune) -> ResidentPlan:
    """The route and launch of one decode of ``shots`` shots on ``device``
    (``tune``: ``resident_plan``'s ``blocks_per_sm`` (default
    :data:`BLOCKS_PER_SM`), ``threads``, ``max_group``, ``pad``).
    ``route="streamed"`` forces the streamed route (before/after
    measurements in one run).  Checks of more than ``MAX_SLOTS`` slots
    (Dc + 2) set ``wide`` (route "wide") on either route."""
    smem, sms = device_limits(KERNEL, device)
    per_shot, fixed, table = resident_bytes(tables, num_rounds)
    width = tables.max_check_degree + 2
    if route == "streamed":
        plan = streamed_plan(shots, table, smem)
    elif route == "auto":
        tune.setdefault("blocks_per_sm", BLOCKS_PER_SM)
        plan = resident_plan(per_shot, table, shots, smem, sms, fixed_bytes=fixed, width=width,
                             **tune)
    else:
        raise ValueError(f"unknown route {route!r}")
    return plan._replace(wide=width > MAX_SLOTS)


def stbp_fixed(tables: TannerTables, num_rounds: int, prior_llr: torch.Tensor,
               syndromes: torch.Tensor, method: str, max_iter: int,
               ms_scaling_factor: float, plan: Optional[ResidentPlan] = None):
    """Same interface and outputs as ``stbp_core(..., early_stop=False)``:
    prior_llr (B·n + R·r,) f32, syndromes (B·r, S) 0/1 -> (hard (Vst, S)
    uint8, posterior (Vst, S) f32, converged (S,) bool, iters (S,) int32).
    ``plan`` overrides :func:`launch_plan` (the benchmarks' sweeps)."""
    method = normalize_method(method)
    if syndromes.device.type == "cpu":
        return stbp_core(tables, num_rounds, prior_llr, syndromes, method, max_iter,
                         ms_scaling_factor, early_stop=False)
    if syndromes.device.type != "cuda":
        raise ValueError(f"stbp_fixed: unsupported device {syndromes.device}")
    dev = syndromes.device
    t = tables
    R, B = int(num_rounds), int(num_rounds) + 1
    r, n, Dc, Dv = t.num_checks, t.num_vars, t.max_check_degree, t.max_var_degree
    Cst, S = syndromes.shape
    if Cst != B * r:
        raise ValueError(f"syndromes have {Cst} rows, expected {B * r}")
    if t.device != dev or prior_llr.device != dev:
        raise ValueError("stbp_fixed: tables, priors and syndromes must share one device")
    n_st = B * n + R * r
    prior = prior_llr.to(torch.float32).contiguous()
    if prior.shape != (n_st,):
        raise ValueError(f"prior_llr must have shape ({n_st},)")
    if max_iter < 0:
        raise ValueError(f"max_iter must be >= 0, got {max_iter}")
    if S == 0:  # a grid of no blocks is not a launch
        return (torch.empty((n_st, 0), dtype=torch.uint8, device=dev),
                torch.empty((n_st, 0), dtype=torch.float32, device=dev),
                torch.empty((0,), dtype=torch.bool, device=dev),
                torch.empty((0,), dtype=torch.int32, device=dev))
    plan = plan or launch_plan(t, R, S, dev)
    synd = syndromes.to(torch.uint8).contiguous()
    scratch = ([torch.empty((rows, S), dtype=torch.float32, device=dev)
                for _name, rows in streamed_scratch(t, R)]
               if plan.route == "streamed" else [None] * 3)
    post = torch.empty((n_st, S), dtype=torch.float32, device=dev)
    conv = torch.empty((S,), dtype=torch.uint8, device=dev)
    (_log.info if plan.route == "streamed" else _log.debug)(
        "K2 %s route: %d shots, %d rounds, r=%d n=%d, %s", plan.label, S, R, r, n, plan)
    KERNEL.launch(
        synd.data_ptr(), prior.data_ptr(), t.chk_vars_k.data_ptr(), t.vm_k.data_ptr(),
        *(0 if a is None else a.data_ptr() for a in scratch), post.data_ptr(), conv.data_ptr(),
        r, n, Dc, Dv, R, S, int(max_iter), 0 if method == "ps" else 1,
        float(ms_scaling_factor), plan.group, plan.stride, plan.threads, int(plan.tables_smem),
        plan.smem_bytes, int(plan.wide), torch.cuda.current_stream(dev).cuda_stream,
        route=plan.label)
    hard = (post <= 0).to(torch.uint8)
    iters = torch.full((S,), int(max_iter), dtype=torch.int32, device=dev)
    return hard, post, conv.bool(), iters
