"""Matrix-product precision microbenchmark at the BP routing shapes.

    python -m exp_ldpc_tpu_torch.experiments.bench_precision_microbench [--device cuda|cpu]

Counterpart of ``scripts/bench_precision_microbench.py``.  The dense
formulation of an HGP-225 BP iteration is two routing products, M (V, C*Dc)
@ c2v (C*Dc, S) and its transpose, plus O(E) elementwise work.  This
measures the rate ``torch.matmul`` reaches at exactly M's shape, V = 225,
C*Dc = 756, S = 1,024 and 4,096, and at a 1,024^3 control, for f32 (TF32
off, ``utils/device.py``), bf16 operands with f32 output (where this
PyTorch's ``mm`` offers ``out_dtype``; else the row says its output is
bf16) and int8 operands with int32 output (``torch._int_mm``, whose inner
dimension must be a multiple of 8: 756 is padded with zero columns and
rows to 760, which leaves the product unchanged and is counted at 756).
These are plain matrix products outside any kernel of the JAX package.

Methodology (the script's): R distinct right-hand operands per run (drawn
on the device, not the host, with a seeded ``torch.Generator``), each
product's sum accumulated so that none is skipped, each run the best of 3
(CUDA events on the card), the time per product the slope between R = 64
and R = 256.  One JSON line per row, the card's name and power limit in
each; ``--device cpu`` runs on the CPU (the tests call :func:`rows` at
small sizes: not a rate of a card).
"""
from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .bench_mxu_dtypes import card_label, timed_s

__all__ = ["V", "CD", "SHOTS", "REPS", "bench_dot", "rows", "main"]

V, CD = 225, 756
SHOTS = (1024, 4096)
REPS = (64, 256)


def _product(dtype: str, dev: torch.device):
    """(a @ b in the row's output type, the output type's name)."""
    if dtype == "int8":
        return torch._int_mm, "int32"
    if dtype == "bf16" and dev.type == "cuda" and "out_dtype" in (torch.mm.__doc__ or ""):
        return (lambda a, b: torch.mm(a, b, out_dtype=torch.float32)), "float32"
    return torch.mm, {"bf16": "bfloat16", "f32": "float32"}[dtype]


def bench_dot(name: str, a_np: np.ndarray, b_np: np.ndarray, dtype: str, dev: torch.device,
              card: str, reps_lo: int = REPS[0], reps_hi: int = REPS[1]) -> dict:
    """One row: the slope time of ``a @ b`` over distinct right-hand sides of
    ``b_np``'s shape, in the row's operand type ``dtype``."""
    mm, out = _product(dtype, dev)
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[dtype]
    m, k = a_np.shape
    kp = -(-k // 8) * 8 if dtype == "int8" else k
    a = torch.zeros((m, kp), dtype=torch.float32)
    a[:, :k] = torch.as_tensor(a_np.astype(np.float32))
    a = a.to(tdt).to(dev)

    def make(R: int):
        """R distinct right-hand sides, integers in [-100, 100) as the script's,
        drawn on the device (seed 1)."""
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        bs = torch.zeros((R, kp, b_np.shape[1]), dtype=tdt, device=dev)
        bs[:, :k] = torch.randint(-100, 100, (R, k, b_np.shape[1]), generator=gen,
                                  device=dev).to(tdt)
        return bs

    def run_many(bs):
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        for b in bs:
            acc += mm(a, b).to(torch.float32).sum()
        return acc

    lo, hi = make(reps_lo), make(reps_hi)
    run_many(lo)
    run_many(hi)
    t_lo = min(timed_s(lambda: run_many(lo), dev) for _ in range(3))
    t_hi = min(timed_s(lambda: run_many(hi), dev) for _ in range(3))
    per = (t_hi - t_lo) / (reps_hi - reps_lo)
    flops = 2 * m * k * b_np.shape[1]
    print(f"{name:>28}: {per*1e6:8.1f} us/matmul  {flops/per/1e12:7.2f} TOP/s", flush=True)
    return {"name": name, "m": m, "k": k, "k_padded": kp, "n": b_np.shape[1],
            "dtype": dtype, "out_dtype": out, "us_per_matmul": per * 1e6,
            "tops": flops / per / 1e12, "reps_lo": reps_lo, "reps_hi": reps_hi,
            "device": dev.type, "card": card}


def rows(dev: torch.device, reps=REPS, shots=SHOTS, control: int = 1024) -> list:
    """The script's rows (M at each S, then the square control), printed as
    its text lines and then one JSON line each; the CPU tests pass small
    sizes."""
    card = card_label(dev)
    print(f"device: {card}", flush=True)
    rng = np.random.default_rng(0)
    M = (rng.random((V, CD)) < 0.01).astype(np.float32)
    out = []
    for S_ in shots:
        print(f"-- M (V={V}, C*Dc={CD}) @ c2v ({CD}, S={S_})", flush=True)
        c2v = rng.standard_normal((CD, S_)).astype(np.float32)
        out.append(bench_dot("f32/f32", M, c2v, "f32", dev, card, *reps))
        out.append(bench_dot("bf16/f32", M, c2v, "bf16", dev, card, *reps))
        out.append(bench_dot("int8/int32", M.astype(np.int8), (c2v * 10).astype(np.int8),
                             "int8", dev, card, *reps))
    n = control
    print(f"-- control ({n},{n})@({n},{n})", flush=True)
    A = rng.standard_normal((n, n)).astype(np.float32)
    B = rng.standard_normal((n, n)).astype(np.float32)
    out.append(bench_dot("f32/f32", A, B, "f32", dev, card, *reps))
    out.append(bench_dot("bf16/f32", A, B, "bf16", dev, card, *reps))
    out.append(bench_dot("int8/int32", (A * 10).astype(np.int8), (B * 10).astype(np.int8),
                         "int8", dev, card, *reps))
    for row in out:
        print(json.dumps(row), flush=True)
    return out


def main(argv: Optional[list] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return rows(resolve_device(ap.parse_args(argv).device))


if __name__ == "__main__":
    main()
