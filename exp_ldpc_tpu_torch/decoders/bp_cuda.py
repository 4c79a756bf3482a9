"""Kernel K6: fixed-iteration flat BP in f32 as one CUDA launch.

Replaces ``exp_ldpc_tpu/decoders/bp_pallas.py::_kernel`` (the VMEM-resident
Pallas kernel, launched by ``bp_pallas_fixed``).  The CUDA source is
``csrc/bpflat.cu``; its header says what bounds it on an H100 and how the
design answers that.  The plain version is :func:`.bp.bp_core` with
``early_stop=False``: its contract is the flat BP stage that the pipeline's
single-shot and hybrid modes run on the device.

:func:`bp_fixed` takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..convert import TannerTables
from ..utils.cuda_build import CudaKernel
from .bp import bp_core, normalize_method

__all__ = ["bp_fixed", "KERNEL"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = CudaKernel("bpflat.cu", "bp_fixed", [_P] * 7 + [_I] * 7 + [_F, _P])


def bp_fixed(tables: TannerTables, prior_llr: torch.Tensor, syndromes: torch.Tensor,
             method: str, max_iter: int, ms_scaling_factor: float):
    """Same interface and outputs as ``bp_core(..., early_stop=False)``:
    prior_llr (V,) f32, syndromes (C, S) 0/1 -> (hard (V, S) uint8,
    posterior (V, S) f32, converged (S,) bool, iters (S,) int32)."""
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
    if Dc > 32:
        raise ValueError(f"bp_fixed supports check degree <= 32, got {Dc}")
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
    synd = syndromes.to(torch.uint8).contiguous()
    msg = torch.empty((C * Dc, S), dtype=torch.float32, device=dev)
    post = torch.empty((V, S), dtype=torch.float32, device=dev)
    conv = torch.empty((S,), dtype=torch.uint8, device=dev)
    KERNEL.launch(
        synd.data_ptr(), prior.data_ptr(), t.chk_vars_k.data_ptr(), t.vm_k.data_ptr(),
        msg.data_ptr(), post.data_ptr(), conv.data_ptr(),
        C, V, Dc, Dv, S, int(max_iter), 0 if method == "ps" else 1, float(ms_scaling_factor),
        torch.cuda.current_stream(dev).cuda_stream)
    hard = (post <= 0).to(torch.uint8)
    iters = torch.full((S,), int(max_iter), dtype=torch.int32, device=dev)
    return hard, post, conv.bool(), iters
