"""Microbench: the dot chain at the BSR routing tile by operand type (K7).

    python -m exp_ldpc_tpu_torch.experiments.bench_mxu_dtypes [--device cuda|cpu]

Counterpart of ``scripts/bench_mxu_dtypes.py``, which times a Pallas kernel
on one TPU chip doing a long chain of 128 x 128 @ 128 x S dots (S = 128) with
bf16, f32 and int8 operands, to learn whether the matrix unit's int8 path
pays before the BSR routing is rewritten.  Here the same chain is kernel K7
(``csrc/dot_chain.cu``: mma.sync on the tensor cores for bf16 and int8, FFMA
on the CUDA cores for f32), and the rows say what rate the card reaches at
that tile, beside its peak (``utils/bounds.py``) and beside cuBLAS on the
same work.

The function (``dot_chain_plain``): a (1024, 128), b (8192, S); step i of
chain/8 adds, for each of 8 accumulators j, the dot a_j @ b_k with
k = (i + 8 j) mod 64, cast to f32; the output (128, S) f32 is the sum of the
8 accumulators in order.  The chain cycles through 64 x 8 = 512 distinct
(a, b) tile pairs feeding 8 rotating accumulators.

Methodology (the script's): new operands for every timed call, each time
the best of 5 (CUDA events on the card), and the time per dot is the slope
between chains of 16,384 and 131,072 dots, which removes the fixed cost of
a call.  Each row adds the bound per dot (operations over the type's peak)
and its share, cuBLAS's rate on one chain period (``library_tflops``: a
chain of 512 visits every (j, k) tile pair once, so one (128 x 65,536) @
(65,536 x S) product over the tiles laid side by side does its work; f32
with TF32 off, int8 by ``torch._int_mm``, bf16 with f32 output where this
PyTorch's ``mm`` offers ``out_dtype``), the card's name and power limit.
int8 rows time the kernel on b laid out per tile transposed (``b_tiles_nk``,
outside the timed window: the kernel's operand layout).  ``--device cpu``
runs the plain version (tests only: not a device rate).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time
from typing import Optional

import numpy as np
import torch

from ..utils.bounds import TENSOR_OPS_PER_S, dot_chain_bound
from ..utils.cuda_build import CudaKernel, aligned
from ..utils.device import resolve_device

__all__ = ["CHAIN_LO", "CHAIN_HI", "S", "DTYPES", "KERNEL", "b_tiles_nk", "dot_chain_parts",
           "dot_chain", "dot_chain_plain", "dot_chain_tolerance", "library_chain", "card_label",
           "timed_s", "operands", "run_case", "rows", "main"]

CHAIN_LO = 16384
CHAIN_HI = 131072
S = 128
_TILE, _NACC, _NTILES = 128, 8, 64
# row name -> operand type; the order of the script's rows
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "int8": torch.int8}
_CODES = {"bf16": 0, "f32": 1, "int8": 2}   # csrc/dot_chain.cu: DT_BF16, DT_F32, DT_INT8

_P, _I = ctypes.c_void_p, ctypes.c_int
# csrc/dot_chain.cu::dot_chain_run: a, b, part, out; S, chain, parts, dtype; the stream
KERNEL = CudaKernel("dot_chain.cu", "dot_chain_run", [_P] * 4 + [_I] * 4 + [_P])


def b_tiles_nk(b: torch.Tensor) -> torch.Tensor:
    """b (8192, S) -> (64, S, 128): each 128-row tile transposed, the layout
    K7 reads int8 b in (no ldmatrix transpose of bytes on sm_90)."""
    return b.reshape(_NTILES, _TILE, b.shape[1]).transpose(1, 2).contiguous()


def dot_chain_parts(chain: int, S: int, sm_count: int) -> int:
    """Parts each accumulator's chain/8 steps are split into: one block per
    SM over the 8 accumulators and S / 128 column tiles, at least one step a
    part."""
    steps = chain // _NACC
    return max(1, min(steps, sm_count // (_NACC * (S // _TILE))))


def _check(a: torch.Tensor, b: torch.Tensor, dtype: str) -> int:
    if dtype not in DTYPES:
        raise ValueError(f"unknown dtype {dtype!r}: expected one of {list(DTYPES)}")
    if a.dtype != DTYPES[dtype] or b.dtype != DTYPES[dtype]:
        raise ValueError(f"dot_chain({dtype!r}) needs {DTYPES[dtype]} operands, got {a.dtype}, "
                         f"{b.dtype}")
    if a.shape != (_NACC * _TILE, _TILE):
        raise ValueError(f"a must be (1024, 128), got {tuple(a.shape)}")
    return int(b.shape[1])   # S in both of b's layouts


def dot_chain_plain(a: torch.Tensor, b: torch.Tensor, chain: int, dtype: str) -> torch.Tensor:
    """Plain version of K7 on the tensors' device: the chain in f32 with
    ``torch.matmul`` (TF32 off: ``utils/device.py``), the 8 accumulators'
    dots of a step as one batched product.  bf16 and int8 operands are cast
    to f32 first, which is exact for every product, and for int8 for every
    dot (at most 2,048 in magnitude)."""
    Sb = _check(a, b, dtype)
    if b.shape != (_NTILES * _TILE, Sb):
        raise ValueError(f"b must be (8192, S), got {tuple(b.shape)}")
    a8 = a.float().reshape(_NACC, _TILE, _TILE)
    b64 = b.float().reshape(_NTILES, _TILE, Sb)
    acc = torch.zeros((_NACC, _TILE, Sb), dtype=torch.float32, device=a.device)
    j8 = torch.arange(_NACC, device=a.device)
    for i in range(chain // _NACC):
        acc = acc + torch.matmul(a8, b64[(i + _NACC * j8) % _NTILES])
    tot = acc[0]
    for k in range(1, _NACC):
        tot = tot + acc[k]
    return tot


def dot_chain_tolerance(a: torch.Tensor, b: torch.Tensor, chain: int, dtype: str,
                        parts: int = 1) -> torch.Tensor:
    """Elementwise bound on |K7 - plain| for bf16 and f32 (int8 is exact):
    each side sums every product through at most D = 128 + chain/8 + parts
    + 8 roundings (a dot's 128 products, the chain's steps, the parts, the 8
    accumulators), each of relative size at most 2^-24 (round to nearest)
    or 2^-23 (the tensor cores' truncating adds), so the two differ by at
    most 2^-22 * D times the same chain on |a| and |b|."""
    depth = _TILE + chain // _NACC + parts + _NACC
    return depth * 2.0 ** -22 * dot_chain_plain(a.abs(), b.abs(), chain, dtype)


def dot_chain(a: torch.Tensor, b: torch.Tensor, chain: int, dtype: str) -> torch.Tensor:
    """The chain of ``chain`` dots: a (1024, 128), b (8192, S) of ``dtype``
    ("bf16", "f32" or "int8"; for int8 b may also come in K7's layout,
    :func:`b_tiles_nk`'s (64, S, 128)) -> (128, S) f32.

    CPU tensors run :func:`dot_chain_plain`.  On a CUDA device one call of
    K7 (a grid over accumulators x parts, then the fixed-order sum of the
    parts) computes it; S must be a multiple of 128."""
    if a.device.type == "cpu":
        return dot_chain_plain(a, b, chain, dtype)
    Sb = _check(a, b, dtype)
    dev = a.device
    if dev.type != "cuda" or b.device != dev:
        raise ValueError(f"dot_chain: a and b must share one CUDA device, got {dev}, {b.device}")
    if chain < 0 or Sb < _TILE or Sb % _TILE:
        raise ValueError(f"dot_chain needs chain >= 0 and S a multiple of 128, got {chain}, {Sb}")
    if dtype == "int8" and b.dim() == 2:
        b = b_tiles_nk(b)
    want = (_NTILES, Sb, _TILE) if dtype == "int8" else (_NTILES * _TILE, Sb)
    if tuple(b.shape) != want:
        raise ValueError(f"b must be {want} here, got {tuple(b.shape)}")
    a, b = a.contiguous(), b.contiguous()
    if not aligned(a, b):
        raise ValueError("dot_chain: operands must start on a 16-byte boundary")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    parts = dot_chain_parts(chain, Sb, sms)
    part = torch.empty((_NACC * parts, _TILE, Sb), dtype=torch.float32, device=dev)
    out = torch.empty((_TILE, Sb), dtype=torch.float32, device=dev)
    KERNEL.launch(a.data_ptr(), b.data_ptr(), part.data_ptr(), out.data_ptr(), Sb, int(chain),
                  parts, _CODES[dtype], torch.cuda.current_stream(dev).cuda_stream)
    return out


def _wide(a: torch.Tensor, b: torch.Tensor, chain: int):
    """(A (128, 128 * chain), B (128 * chain, S)): the chain's dot pairs, in
    order, laid side by side, so that A @ B is the sum of all its dots."""
    i = torch.arange(chain // _NACC, device=a.device)
    j = torch.arange(_NACC, device=a.device)
    jj = j.repeat(chain // _NACC)
    kk = ((i[:, None] + _NACC * j[None, :]) % _NTILES).reshape(-1)
    A = a.reshape(_NACC, _TILE, _TILE)[jj].permute(1, 0, 2).reshape(_TILE, -1)
    B = b.reshape(_NTILES, _TILE, b.shape[1])[kk].reshape(-1, b.shape[1])
    return A.contiguous(), B.contiguous()


def library_chain(a: torch.Tensor, b: torch.Tensor, chain: int, dtype: str):
    """(the one PyTorch call that does the chain's work on its operands laid
    side by side, its output type): f32 ``mm`` with TF32 off, bf16 ``mm``
    with f32 output where this PyTorch offers ``out_dtype`` (else bf16),
    int8 ``torch._int_mm`` (int32).  A yardstick only: the port never calls
    it."""
    A, B = _wide(a, b, chain)
    if dtype == "int8":
        return (lambda: torch._int_mm(A, B)), "int32"
    if dtype == "bf16" and A.is_cuda and "out_dtype" in (torch.mm.__doc__ or ""):
        return (lambda: torch.mm(A, B, out_dtype=torch.float32)), "float32"
    return (lambda: torch.mm(A, B)), str(A.dtype).replace("torch.", "")


def card_label(dev: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_s(fn, dev: torch.device) -> float:
    """Seconds of ``fn()``: CUDA events on the card, the host clock on the CPU."""
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def operands(rng: np.random.Generator, dtype: str, dev: torch.device, Sb: int = S):
    """New (a, b) of one row, the script's draws: int8 in [-4, 4], else
    standard normal rounded to the type."""
    if dtype == "int8":
        a = rng.integers(-4, 5, (1024, 128), dtype=np.int8)
        b = rng.integers(-4, 5, (64 * 128, Sb), dtype=np.int8)
        return torch.as_tensor(a).to(dev), torch.as_tensor(b).to(dev)
    a = torch.as_tensor(rng.standard_normal((1024, 128)).astype(np.float32))
    b = torch.as_tensor(rng.standard_normal((64 * 128, Sb)).astype(np.float32))
    return a.to(DTYPES[dtype]).to(dev), b.to(DTYPES[dtype]).to(dev)


def run_case(name: str, dev: torch.device, rng: np.random.Generator, card: str,
             chain_lo: int = CHAIN_LO, chain_hi: int = CHAIN_HI, runs: int = 5) -> dict:
    """One row: the kernel's best time of ``runs`` calls at each chain, each
    on new operands (b laid out for the kernel outside the timed window),
    the slope per dot, its bound and share, and cuBLAS's rate on one chain
    period."""
    def kernel_operands():
        a, b = operands(rng, name, dev)
        return a, (b_tiles_nk(b) if name == "int8" and dev.type == "cuda" else b)

    def best(chain: int) -> float:
        a, b = kernel_operands()
        dot_chain(a, b, chain, name)   # build + warm
        _sync(dev)
        ts = []
        for _ in range(runs):
            a, b = kernel_operands()
            ts.append(timed_s(lambda: dot_chain(a, b, chain, name), dev))
        return min(ts)

    t_lo, t_hi = best(chain_lo), best(chain_hi)
    per_dot = (t_hi - t_lo) / (chain_hi - chain_lo)
    flops = 2 * 128 * 128 * S
    period = _NACC * _NTILES
    lib_ts, lib_out = [], None
    for _ in range(runs):
        fn, lib_out = library_chain(*operands(rng, name, dev), period, name)
        fn()   # warm (cuBLAS picks its algorithm at the first call of a shape)
        lib_ts.append(timed_s(fn, dev))
    lib_per_dot = min(lib_ts) / period
    bound_ns = dot_chain_bound(name, 1, S)["bound_ops"] / TENSOR_OPS_PER_S[name] * 1e9
    row = {
        "dtype": name, "s": S,
        "tflops": flops / per_dot / 1e12,
        "ns_per_dot": per_dot * 1e9,
        "chain_lo": chain_lo, "chain_hi": chain_hi,
        "t_hi_s": t_hi, "t_lo_s": t_lo,
        "peak_tflops": TENSOR_OPS_PER_S[name] / 1e12,
        "bound_ns_per_dot": bound_ns,
        "bound_by": dot_chain_bound(name, chain_hi, S)["bound_by"],
        "bound_share": bound_ns / (per_dot * 1e9),
        "library_tflops": flops / lib_per_dot / 1e12,
        "library_ns_per_dot": lib_per_dot * 1e9,
        "library_out_dtype": lib_out,
        "int8_b_layout": "per-tile transposed (64, S, 128), laid out outside the timed window"
        if name == "int8" else None,
        "device": dev.type, "card": card,
    }
    return row


def rows(dev: torch.device, chain_lo: int = CHAIN_LO, chain_hi: int = CHAIN_HI,
         runs: int = 5) -> list:
    """The script's three rows (bf16, f32, int8), each printed as a JSON line;
    the CPU tests pass short chains."""
    card = card_label(dev)
    rng = np.random.default_rng(0)
    out = []
    for name in DTYPES:
        row = run_case(name, dev, rng, card, chain_lo, chain_hi, runs)
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def main(argv: Optional[list] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain version)")
    return rows(resolve_device(ap.parse_args(argv).device))


if __name__ == "__main__":
    main()
