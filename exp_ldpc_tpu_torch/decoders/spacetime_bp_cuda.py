"""Kernel K2: fixed-iteration structured spacetime BP as one CUDA launch.

Replaces ``exp_ldpc_tpu/decoders/spacetime_bp_pallas.py::_kernel`` (the
VMEM-resident Pallas kernel, launched by ``stbp_pallas_fixed``).  The CUDA
source is ``csrc/stbp.cu``; its header says what bounds it on an H100 and
how the design answers that.  The plain version is
:func:`.spacetime_bp.stbp_core` with ``early_stop=False``.

:func:`stbp_fixed` takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..convert import TannerTables
from ..utils.cuda_build import CudaKernel
from .bp import normalize_method
from .spacetime_bp import stbp_core

__all__ = ["stbp_fixed", "KERNEL"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = CudaKernel("stbp.cu", "stbp_fixed",
                    [_P] * 9 + [_I] * 8 + [_F, _P])


def stbp_fixed(tables: TannerTables, num_rounds: int, prior_llr: torch.Tensor,
               syndromes: torch.Tensor, method: str, max_iter: int,
               ms_scaling_factor: float):
    """Same interface and outputs as ``stbp_core(..., early_stop=False)``:
    prior_llr (B·n + R·r,) f32, syndromes (B·r, S) 0/1 -> (hard (Vst, S)
    uint8, posterior (Vst, S) f32, converged (S,) bool, iters (S,) int32)."""
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
    if Dc + 2 > 32:
        raise ValueError(f"stbp_fixed supports check degree <= 30, got {Dc}")
    if t.device != dev or prior_llr.device != dev:
        raise ValueError("stbp_fixed: tables, priors and syndromes must share one device")
    n_st = B * n + R * r
    prior = prior_llr.to(torch.float32).contiguous()
    if prior.shape != (n_st,):
        raise ValueError(f"prior_llr must have shape ({n_st},)")
    synd = syndromes.to(torch.uint8).contiguous()
    msg = torch.empty((B * r * Dc, S), dtype=torch.float32, device=dev)
    mlo = torch.empty((max(R * r, 1), S), dtype=torch.float32, device=dev)
    mhi = torch.empty_like(mlo)
    post = torch.empty((n_st, S), dtype=torch.float32, device=dev)
    conv = torch.empty((S,), dtype=torch.uint8, device=dev)
    KERNEL.launch(
        synd.data_ptr(), prior.data_ptr(), t.chk_vars_k.data_ptr(), t.vm_k.data_ptr(),
        msg.data_ptr(), mlo.data_ptr(), mhi.data_ptr(), post.data_ptr(), conv.data_ptr(),
        r, n, Dc, Dv, R, S, int(max_iter), 0 if method == "ps" else 1,
        float(ms_scaling_factor),
        torch.cuda.current_stream(dev).cuda_stream)
    hard = (post <= 0).to(torch.uint8)
    iters = torch.full((S,), int(max_iter), dtype=torch.int32, device=dev)
    return hard, post, conv.bool(), iters
