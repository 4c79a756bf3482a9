"""Kernel K6: fixed-iteration flat BP in f32, a whole decode in one call.

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
HGP) keeps them in device memory and runs each phase of an iteration as one
grid over (row, shot vector) items, two grids an iteration and a parity
grid, all enqueued by one call (:class:`..utils.cuda_build.StreamedPlan`;
the shots padded to a multiple of 4, the padded columns dropped from every
output).  Checks of more than ``MAX_SLOTS`` (32) slots take route "wide" on
either route (a two-pass check phase), which the plan sets from the degree.
``KERNEL.launches`` counts decodes, ``KERNEL.routes`` splits the count by
route (the plan's ``label``).

:func:`bp_fixed` takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import logging
from typing import Dict, Optional, Tuple, Union

import torch

from ..convert import TannerTables
from ..utils.cuda_build import (MAX_SLOTS, CudaKernel, ResidentPlan, StreamedPlan,
                                device_limits, pad_shots, resident_fit, resident_plan,
                                streamed_plan)
from .bp import bp_core, normalize_method

__all__ = ["bp_fixed", "launch_plan", "streams", "resident_bytes", "streamed_scratch",
           "streamed_buffers", "live_outputs", "KERNEL", "STREAMED_MAX_FIT", "STREAMED_MIN_WIDTH"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# csrc/bpflat.cu::bp_fixed: 7 arrays; C, V, Dc, Dv, S, max_iter, method; alpha0; the resident
# plan (group, stride, threads, tables_smem, smem_bytes), wide, the streamed plan
# (StreamedPlan.launch_args); the stream
KERNEL = CudaKernel("bpflat.cu", "bp_fixed", [_P] * 7 + [_I] * 7 + [_F] + [_I] * 10 + [_P])
Plan = Union[ResidentPlan, StreamedPlan]
_log = logging.getLogger(__name__)
# Blocks side by side per SM at batches past one wave: the winner of
# experiments/bench_resident.py's sweep at (H|I) 16,384 x 48 (PERF.md §6).
BLOCKS_PER_SM = 1
# The streamed route beats the resident one where at most STREAMED_MAX_FIT
# shots fit a resident block and the checks hold at least STREAMED_MIN_WIDTH
# slots (experiments/bench_resident.py, NVIDIA H100 80GB HBM3, 700 W, 685 /
# 2,048 shots x 48, resident against streamed ms): 18 slots, 2 and 1 shots
# (HGP n = 2,880 and 4,500) 8.26 / 22.1 against 5.92 / 15.9 and 12.9 / 34.4
# against 9.27 / 24.2; 20 slots, 1 shot (n = 3,200) 10.6 / 28.4 against 8.96
# / 23.6; the cyclic lifted product n = 4,862, 24 slots, 1 shot, 20.3 / 54.5
# against 8.72 / 22.9; the 1-round circuit-noise detector model, 53 slots, 2
# shots, 2.80 / 7.27 against 2.27 / 5.59.  At 12 slots it splits (1 shot, n
# = 8,000: 11.0 / 29.4 against 9.91 / 26.7; 2 shots, n = 4,500: 5.30 / 14.0
# against 5.70 / 15.5); it loses at 7 slots (HGP n = 10,000, 1 shot: 5.59 /
# 15.0 against 7.88 / 20.8) and where more shots fit (HGP n = 2,025 and
# 1,600, 3-8 shots: 1.3-2.0x).
STREAMED_MAX_FIT, STREAMED_MIN_WIDTH = 2, 17


def streamed_scratch(tables: TannerTables) -> Tuple[Tuple[str, int], ...]:
    """Rows of the streamed route's f32 device-memory scratch, each (row,
    padded S): the messages."""
    return (("msg", tables.num_checks * tables.max_check_degree),)


def streamed_buffers(tables: TannerTables, syndromes: torch.Tensor,
                     plan: StreamedPlan) -> Dict[str, torch.Tensor]:
    """The arrays of one streamed decode on the syndromes' device, each
    ``plan.shots`` columns wide: the syndromes as uint8 with all-zero padded
    columns, the scratch of :func:`streamed_scratch`, the posterior and
    conv."""
    dev, S = syndromes.device, plan.shots
    out = {"synd": pad_shots(syndromes.to(torch.uint8), S)}
    for name, rows in streamed_scratch(tables):
        out[name] = torch.empty((rows, S), dtype=torch.float32, device=dev)
    out["post"] = torch.empty((tables.num_vars, S), dtype=torch.float32, device=dev)
    out["conv"] = torch.empty((S,), dtype=torch.uint8, device=dev)
    return out


def live_outputs(post: torch.Tensor, conv: torch.Tensor, live: int, max_iter: int):
    """(hard, posterior, converged, iters) of the first ``live`` shots of a
    decode's (rows, padded S) posterior and (padded S,) conv: no padded shot
    reaches an output."""
    if post.shape[1] != live:
        post = post[:, :live].contiguous()
    hard = (post <= 0).to(torch.uint8)
    iters = torch.full((live,), int(max_iter), dtype=torch.int32, device=post.device)
    return hard, post, conv[:live].bool(), iters


def resident_bytes(tables: TannerTables) -> Tuple[int, int, int]:
    """(bytes per shot, fixed bytes, table bytes) of a resident block's
    shared memory (``csrc/bpflat.cu::bp_resident_bytes``): per shot every
    f32 message, its syndrome bytes and a flag; fixed, each check's
    live-slot mask; the two Tanner tables (int32)."""
    C, V, Dc, Dv = (tables.num_checks, tables.num_vars, tables.max_check_degree,
                    tables.max_var_degree)
    return 4 * (C * Dc + 1) + C, 4 * C, 4 * (C * Dc + V * Dv)


def streams(tables, smem: int) -> bool:
    """Whether a decode over ``tables`` (or a ``TannerELL``) takes the
    streamed route on a card of ``smem`` bytes of opt-in shared memory per
    block: one shot does not fit a resident block, or at most
    :data:`STREAMED_MAX_FIT` shots fit and the checks hold at least
    :data:`STREAMED_MIN_WIDTH` slots."""
    per_shot, fixed, table = resident_bytes(tables)
    if per_shot + fixed > smem:
        return True
    return (tables.max_check_degree >= STREAMED_MIN_WIDTH
            and resident_fit(per_shot, table, smem, fixed)[1] <= STREAMED_MAX_FIT)


def launch_plan(tables: TannerTables, shots: int, device: torch.device, route: str = "auto",
                **tune) -> Plan:
    """The route and launch of one decode of ``shots`` shots on ``device``
    (``tune``: ``resident_plan``'s ``blocks_per_sm`` (default
    :data:`BLOCKS_PER_SM`), ``threads``, ``max_group``, ``pad``): the
    streamed route where :func:`streams`, else the resident route.
    ``route="streamed"`` or ``"resident"`` forces one (comparisons in one
    run; ``"resident"`` raises where one shot does not fit).  Checks of more
    than ``MAX_SLOTS`` slots set ``wide`` (route "wide") on either route."""
    if route not in ("auto", "streamed", "resident"):
        raise ValueError(f"unknown route {route!r}")
    smem, sms = device_limits(KERNEL, device)
    C, V, Dc = tables.num_checks, tables.num_vars, tables.max_check_degree
    if route == "streamed" or (route == "auto" and streams(tables, smem)):
        return streamed_plan(C, V, shots, Dc, sms)
    per_shot, fixed, table = resident_bytes(tables)
    tune.setdefault("blocks_per_sm", BLOCKS_PER_SM)
    plan = resident_plan(per_shot, table, shots, smem, sms, fixed_bytes=fixed, width=Dc, **tune)
    if plan is None and route == "auto":   # a tuned row pad that no longer fits
        return streamed_plan(C, V, shots, Dc, sms)
    if plan is None:
        raise ValueError(f"K6: one shot ({per_shot + fixed} B) does not fit {smem} B of shared "
                         "memory: no resident route")
    return plan._replace(wide=Dc > MAX_SLOTS)


def bp_fixed(tables: TannerTables, prior_llr: torch.Tensor, syndromes: torch.Tensor,
             method: str, max_iter: int, ms_scaling_factor: float,
             plan: Optional[Plan] = None):
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
    (_log.info if plan.route == "streamed" else _log.debug)(
        "K6 %s route: %d shots, C=%d V=%d, %s", plan.label, S, C, V, plan)
    if plan.route == "streamed":
        if plan.live != S:
            raise ValueError(f"bp_fixed: the plan is for {plan.live} shots, not {S}")
        buf = streamed_buffers(t, syndromes, plan)
        synd, msg, post, conv = buf["synd"], buf["msg"], buf["post"], buf["conv"]
        resident = (0,) * 5
        grids = plan.launch_args
        S_k = plan.shots
    else:
        synd = syndromes.to(torch.uint8).contiguous()
        msg = None
        post = torch.empty((V, S), dtype=torch.float32, device=dev)
        conv = torch.empty((S,), dtype=torch.uint8, device=dev)
        resident = (plan.group, plan.stride, plan.threads, int(plan.tables_smem),
                    plan.smem_bytes)
        grids = (0,) * 4
        S_k = S
    KERNEL.launch(
        synd.data_ptr(), prior.data_ptr(), t.chk_vars_k.data_ptr(), t.vm_k.data_ptr(),
        0 if msg is None else msg.data_ptr(), post.data_ptr(), conv.data_ptr(),
        C, V, Dc, Dv, S_k, int(max_iter), 0 if method == "ps" else 1, float(ms_scaling_factor),
        *resident, int(plan.wide), *grids, torch.cuda.current_stream(dev).cuda_stream,
        route=plan.label)
    return live_outputs(post, conv, S, max_iter)
