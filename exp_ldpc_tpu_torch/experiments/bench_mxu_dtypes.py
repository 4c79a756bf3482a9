"""Microbench: the dot chain at the BSR routing tile by operand type (K7).

    python -m exp_ldpc_tpu_torch.experiments.bench_mxu_dtypes [--device cuda|cpu]

Counterpart of ``scripts/bench_mxu_dtypes.py``, which times a Pallas kernel
on one TPU chip doing a long chain of 128 x 128 @ 128 x S dots (S = 128) with
bf16, f32 and int8 operands, to learn whether the matrix unit's int8 path
pays before the BSR routing is rewritten.  Here the same chain is kernel K7
(``csrc/dot_chain.cu``: ``wgmma`` fed by TMA on the tensor cores for bf16
and int8, FFMA on the CUDA cores for f32), and the rows say what rate the
card reaches at that tile, beside its peak (``utils/bounds.py``) and beside
cuBLAS on the same work.

The function (``dot_chain_plain``): a (1024, 128), b (8192, S); step i of
chain/8 adds, for each of 8 accumulators j, the dot a_j @ b_k with
k = (i + 8 j) mod 64, cast to f32; the output (128, S) f32 is the sum of the
8 accumulators in order.  The chain cycles through 64 x 8 = 512 distinct
(a, b) tile pairs feeding 8 rotating accumulators.

Methodology (the script's): new operands for every timed call, each time
the best of 5, and the time per dot is the slope between chains of 16,384
and 131,072 dots, which removes the fixed cost of a call (``fixed_ms``:
t_lo - slope x chain_lo).  On the card a time is the device's (CUDA events
around work the host has already enqueued, :func:`device_s`), so that the
host's launch jitter does not enter the slope; the host's time to enqueue
one call is ``host_ms``.  Each row adds the bound per dot (operations over
the type's published peak) and its share, the slope's share of the peak at
the card's largest SM clock (``clock_share``: the published bf16 and int8
peaks are at a lower clock than f32's), cuBLAS's rate on one chain period
(``library_tflops``: a chain of 512 visits every (j, k) tile pair once, so
one (128 x 65,536) @ (65,536 x S) product over the tiles laid side by side
does its work; f32 with TF32 off, int8 by ``torch._int_mm`` on a
column-major B, bf16 with f32 output where this PyTorch's ``mm`` offers
``out_dtype``), the L2 read rate the kernel needs at its measured slope and
at the peak (a b tile a dot) beside a ``torch`` copy of b (which stays in
L2), and the card's name and power limit.  int8 rows time the kernel on b
laid out per tile transposed (``b_tiles_nk``) and cuBLAS on its column-major
B, both laid out outside the timed window.  ``--device cpu`` runs the plain
version (tests only: not a device rate).
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.bounds import TENSOR_OPS_PER_S, clock_peak, dot_chain_bound
from ..utils.cuda_build import CudaKernel, aligned
from ..utils.device import resolve_device

__all__ = ["CHAIN_LO", "CHAIN_HI", "S", "DTYPES", "KERNEL", "DotChainPlan", "b_tiles_nk",
           "dot_chain_plan", "dot_chain_walk", "dot_chain_planned", "dot_chain",
           "dot_chain_plain", "dot_chain_tolerance", "library_chain", "card_label",
           "sm_clock_max_mhz", "timed_s", "device_s", "operands", "run_case", "rows", "main"]

CHAIN_LO = 16384
CHAIN_HI = 131072
S = 128
_TILE, _NACC, _NTILES = 128, 8, 64
# row name -> operand type; the order of the script's rows
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "int8": torch.int8}
_CODES = {"bf16": 0, "f32": 1, "int8": 2}   # csrc/dot_chain.cu: DT_BF16, DT_F32, DT_INT8

_P, _I = ctypes.c_void_p, ctypes.c_int
# csrc/dot_chain.cu::dot_chain_run: a, b, part, out; S, chain, blocks, dtype; the stream
KERNEL = CudaKernel("dot_chain.cu", "dot_chain_run", [_P] * 4 + [_I] * 4 + [_P])


def b_tiles_nk(b: torch.Tensor) -> torch.Tensor:
    """b (8192, S) -> (64, S, 128): each 128-row tile transposed, the layout
    K7 reads int8 b in (no ldmatrix transpose of bytes on sm_90)."""
    return b.reshape(_NTILES, _TILE, b.shape[1]).transpose(1, 2).contiguous()


class DotChainPlan(NamedTuple):
    """K7's grid: ``blocks`` blocks a column tile over ``col_tiles`` column
    tiles.  The chain's 8 * ``steps`` dots, accumulator-major (dot q is
    step q mod steps of accumulator q // steps), are split evenly: block b
    takes [D b / blocks, D (b + 1) / blocks), D = 8 steps, one partial per
    accumulator its range meets (``csrc/dot_chain.cu``, the note)."""

    steps: int
    blocks: int
    col_tiles: int

    def ranges(self) -> list:
        d = _NACC * self.steps
        return [(d * b // self.blocks, d * (b + 1) // self.blocks) for b in range(self.blocks)]

    @property
    def parts(self) -> int:
        """The most partials one accumulator is split into (the term of
        :func:`dot_chain_tolerance`)."""
        per = [0] * _NACC
        for b in range(self.blocks):
            for j, _, _ in dot_chain_walk(self, b):
                per[j] += 1
        return max(1, max(per))


def dot_chain_plan(chain: int, S: int, sm_count: int) -> DotChainPlan:
    """One block per SM, the SMs shared by the S / 128 column tiles, at
    least 8 blocks a column tile (so a block's range is at most chain/8 dots
    and meets at most two accumulators) and no more blocks than dots."""
    steps = chain // _NACC
    tiles = S // _TILE
    blocks = max(1, min(_NACC * steps, max(_NACC, sm_count // tiles)))
    if blocks > 1024:   # csrc/dot_chain.cu: MAX_BLOCKS
        raise ValueError(f"{blocks} blocks a column tile: K7 takes at most 1,024")
    return DotChainPlan(steps, blocks, tiles)


def dot_chain_walk(plan: DotChainPlan, b: int) -> list:
    """Block b's partials, in order, as (accumulator j, first step, dots):
    it sums steps first .. first + dots - 1 of accumulator j from zero (the
    kernel's ``Range``)."""
    q0, q1 = plan.ranges()[b]
    walk = []
    while q0 < q1:
        j, i = divmod(q0, plan.steps)
        n = min(q1, (j + 1) * plan.steps) - q0
        walk.append((j, i, n))
        q0 += n
    return walk


def dot_chain_planned(a: torch.Tensor, b: torch.Tensor, chain: int, dtype: str,
                      plan: DotChainPlan) -> torch.Tensor:
    """K7's order of additions on the tensors' device in f32: each partial
    sums its dots from zero in step order, then the partials are added in
    the kernel's fixed order (each accumulator's partials in block order,
    then the accumulators).  Only the dots themselves differ from the
    kernel (here ``torch.matmul``)."""
    Sb = _check(a, b, dtype)
    a8 = a.float().reshape(_NACC, _TILE, _TILE)
    b64 = b.float().reshape(_NTILES, _TILE, Sb)
    out = torch.zeros((_TILE, Sb), dtype=torch.float32, device=a.device)
    for t in range(plan.col_tiles):
        cols = slice(_TILE * t, _TILE * (t + 1))
        acc = [None] * _NACC
        for blk in range(plan.blocks):
            for j, first, n in dot_chain_walk(plan, blk):
                part = torch.zeros((_TILE, _TILE), dtype=torch.float32, device=a.device)
                for i in range(first, first + n):
                    part = part + a8[j] @ b64[(i + _NACC * j) % _NTILES][:, cols]
                acc[j] = part if acc[j] is None else acc[j] + part
        if plan.steps:
            tot = acc[0]
            for j in range(1, _NACC):
                tot = tot + acc[j]
            out[:, cols] = tot
    return out


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


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_card_plan = functools.lru_cache(maxsize=256)(dot_chain_plan)


def dot_chain(a: torch.Tensor, b: torch.Tensor, chain: int, dtype: str) -> torch.Tensor:
    """The chain of ``chain`` dots: a (1024, 128), b (8192, S) of ``dtype``
    ("bf16", "f32" or "int8"; for int8 b may also come in K7's layout,
    :func:`b_tiles_nk`'s (64, S, 128)) -> (128, S) f32.

    CPU tensors run :func:`dot_chain_plain`.  On a CUDA device one call of
    K7 (the chain's dots split evenly over one block an SM,
    :func:`dot_chain_plan`, then the fixed-order sum of the partials)
    computes it; S must be a multiple of 128."""
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
    index = torch.cuda.current_device() if dev.index is None else dev.index
    plan = _card_plan(chain, Sb, _sm_count(index))
    part = torch.empty((2 * plan.blocks, _TILE, Sb), dtype=torch.float32, device=dev)
    out = torch.empty((_TILE, Sb), dtype=torch.float32, device=dev)
    KERNEL.launch(a.data_ptr(), b.data_ptr(), part.data_ptr(), out.data_ptr(), Sb, int(chain),
                  plan.blocks, _CODES[dtype], torch.cuda.current_stream(dev).cuda_stream)
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
    int8 ``torch._int_mm`` (int32) on B laid out column-major here, outside
    the call (the layout cuBLASLt's int8 product serves best, as K7 gets its
    own b layout outside the timed window).  A yardstick only: the port never
    calls it."""
    A, B = _wide(a, b, chain)
    if dtype == "int8":
        Bc = B.t().contiguous().t()
        return (lambda: torch._int_mm(A, Bc)), "int32"
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


def sm_clock_max_mhz(dev: torch.device) -> Optional[float]:
    """The card's highest SM clock (``nvidia-smi``'s ``clocks.max.sm``, MHz),
    the clock of :func:`utils.bounds.clock_peak`; None on the CPU."""
    if dev.type != "cuda":
        return None
    index = torch.cuda.current_device() if dev.index is None else dev.index
    out = subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.split()[0])


# ~2.1 ms of device-side wait at 1,980 MHz: several times the host's enqueue
# of one call of K7 or of cuBLAS (``host_ms``: 0.07-0.27 ms on a shared host)
_HIDE_CYCLES = 1 << 22


def device_s(fn, dev: torch.device, tries: int = 3) -> float:
    """Seconds the card spends on ``fn()``: CUDA events around work the host
    has already enqueued (a device-side wait ahead of the first event covers
    the host's launch time, which ``run_case`` reports on its own).  A sample
    in which the card reached the first event before the host had enqueued
    the last is taken again; after ``tries`` such samples this raises.  The
    host clock on the CPU."""
    if dev.type != "cuda":
        return timed_s(fn, dev)
    for _ in range(tries):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        torch.cuda._sleep(_HIDE_CYCLES)
        start.record()
        fn()
        end.record()
        late = start.query()   # the wait ran out while the host still enqueued
        torch.cuda.synchronize(dev)
        if not late:
            return start.elapsed_time(end) / 1e3
    raise RuntimeError(f"device_s: the host's enqueue outlasted a wait of {_HIDE_CYCLES} cycles "
                       f"{tries} times")


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


_TILE_BYTES = {"bf16": _TILE * _TILE * 2, "f32": _TILE * _TILE * 4, "int8": _TILE * _TILE}


def _copy_s(b: torch.Tensor, dev: torch.device, runs: int) -> float:
    """Seconds a ``torch`` copy takes to read b once out of L2: one
    contiguous copy of R copies of b stacked (16 MB, so that the copy and not
    its launch is timed; source and destination, 32 MB, stay in the 50 MB
    L2), the best of ``runs`` device times (:func:`device_s`)."""
    r = max(1, (16 << 20) // (b.numel() * b.element_size()))
    src = b.repeat(r, *([1] * (b.dim() - 1)))
    dst = torch.empty_like(src)
    dst.copy_(src)
    return min(device_s(lambda: dst.copy_(src), dev) for _ in range(runs)) / r


def run_case(name: str, dev: torch.device, rng: np.random.Generator, card: str,
             chain_lo: int = CHAIN_LO, chain_hi: int = CHAIN_HI, runs: int = 5,
             mhz: Optional[float] = None) -> dict:
    """One row: the kernel's best device time of ``runs`` calls at each chain
    (:func:`device_s`), each on new operands (b laid out for the kernel
    outside the timed window), the slope per dot, its bound and share at the
    published peak, its share of the peak at the card's clock ``mhz`` (the
    largest SM clock, :func:`sm_clock_max_mhz`; None on the CPU), the fixed
    cost of a call on the card and the host's time to enqueue one, cuBLAS's
    rate on one chain period and its time on the chain_lo work
    (``library_ms_lo``, timed the same way), and the L2 read rate the kernel
    needs beside a copy's."""
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
            ts.append(device_s(lambda: dot_chain(a, b, chain, name), dev))
        return min(ts)

    def host_s() -> float:   # enqueueing one call, the card idle
        hs = []
        for _ in range(runs):
            a, b = kernel_operands()
            _sync(dev)
            t0 = time.perf_counter()
            dot_chain(a, b, chain_lo, name)
            hs.append(time.perf_counter() - t0)
        _sync(dev)
        return min(hs)

    t_lo, t_hi = best(chain_lo), best(chain_hi)
    host = host_s()
    per_dot = (t_hi - t_lo) / (chain_hi - chain_lo)
    flops = 2 * 128 * 128 * S
    period = _NACC * _NTILES
    lib_ts, lib_out = [], None
    for _ in range(runs):
        fn, lib_out = library_chain(*operands(rng, name, dev), period, name)
        fn()   # warm (cuBLAS picks its algorithm at the first call of a shape)
        lib_ts.append(device_s(fn, dev))
    lib_per_dot = min(lib_ts) / period
    fn, _ = library_chain(*operands(rng, name, dev), chain_lo, name)
    fn()
    lib_lo = min(device_s(fn, dev) for _ in range(runs))
    del fn
    bound_ns = dot_chain_bound(name, 1, S)["bound_ops"] / TENSOR_OPS_PER_S[name] * 1e9
    sms = torch.cuda.get_device_properties(dev).multi_processor_count if mhz else None
    peak_clock = clock_peak(name, sms, mhz) if mhz else None
    l2_bytes = _TILE_BYTES[name]   # read from L2 a dot: one b tile
    b_copy = operands(rng, name, dev)[1]
    copy_s = _copy_s(b_copy, dev, runs)
    row = {
        "dtype": name, "s": S,
        "tflops": flops / per_dot / 1e12,
        "ns_per_dot": per_dot * 1e9,
        "chain_lo": chain_lo, "chain_hi": chain_hi,
        "t_hi_s": t_hi, "t_lo_s": t_lo,
        "fixed_ms": (t_lo - per_dot * chain_lo) * 1e3,
        "host_ms": host * 1e3,
        "peak_tflops": TENSOR_OPS_PER_S[name] / 1e12,
        "bound_ns_per_dot": bound_ns,
        "bound_by": dot_chain_bound(name, chain_hi, S)["bound_by"],
        "bound_share": bound_ns / (per_dot * 1e9),
        "library_tflops": flops / lib_per_dot / 1e12,
        "library_ns_per_dot": lib_per_dot * 1e9,
        "library_out_dtype": lib_out,
        "library_ms_lo": lib_lo * 1e3,
        "library_b_layout": "column-major (B.t().contiguous().t()), laid out outside the timed "
        "window" if name == "int8" else "row-major",
        "int8_b_layout": "per-tile transposed (64, S, 128), laid out outside the timed window"
        if name == "int8" else None,
        "l2_bytes_per_dot": l2_bytes,
        "l2_tbps_needed": l2_bytes / per_dot / 1e12,
        "l2_tbps_needed_at_peak": l2_bytes / bound_ns * 1e-3,
        "l2_copy_tbps": b_copy.numel() * b_copy.element_size() / copy_s / 1e12,
        "sm_count": sms, "sm_clock_max_mhz": mhz,
        "clock_peak_tflops": peak_clock / 1e12 if mhz else None,
        "clock_share": flops / per_dot / peak_clock if mhz else None,
        "device": dev.type, "card": card,
    }
    return row


def rows(dev: torch.device, chain_lo: int = CHAIN_LO, chain_hi: int = CHAIN_HI,
         runs: int = 5) -> list:
    """The script's three rows (bf16, f32, int8), each printed as a JSON line;
    the CPU tests pass short chains."""
    card, mhz = card_label(dev), sm_clock_max_mhz(dev)
    rng = np.random.default_rng(0)
    out = []
    for name in DTYPES:
        row = run_case(name, dev, rng, card, chain_lo, chain_hi, runs, mhz)
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def main(argv: Optional[list] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain version)")
    return rows(resolve_device(ap.parse_args(argv).device))


if __name__ == "__main__":
    main()
