"""Times the flat BP kernels K1 (bf16) and K5 (int8) at every shape PERF.md reports.

    python -m exp_ldpc_tpu_torch.experiments.bench_bsr [--plain] [--variants]

Shapes (min-sum, alpha 0.625 / ``alpha_num`` 160, flat priors at p):

  * HGP-225's (H|I), 16,384 shots x 48 iterations at p = 5e-3, fixed and
    with the early exit; 685 shots (the host redecode's size) both ways;
  * HGP-225's H, 1,024 x 32 at p = 1e-3 (``bench_bp``'s configuration);
  * ``biregular_hgp(160, 3, 4)`` (n = 40,000, >= 3,000 BSR tiles: the
    regime of the rolled TPU kernel K1b), 256 x 8 at p = 2e-3;
  * the family benchmark's kernel codes at 1,024 x 32, p = 1e-3, shot
    block 128: the cyclic lifted product n = 4,862 in QC order and the QC
    lifted product [[1054,140]]; K1 and K5 each.

Each time is the median over ``--runs`` distinct syndrome batches (drawn
on the device from a fixed seed) of one decode between two CUDA events,
after one warm-up decode; with the early exit the row also gives the
shot-iterations the batches needed (what a data-dependent bound counts).
``--plain`` times the plain PyTorch versions too; ``--variants`` re-times
a few shapes with other lane widths, and K1 on one grid per phase where it
takes its cooperative route (the plan's alternatives).  Only the
decoders' public functions are called, so the same script times another
checkout of the port (run it with that checkout first on the path).  One
JSON line per row, the card's name and power limit in each; needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from contextlib import ExitStack
from unittest import mock

import numpy as np
import torch

from exp_ldpc_tpu_torch.codes.hgp import biregular_hgp
from exp_ldpc_tpu_torch.decoders import bp_bsr
from exp_ldpc_tpu_torch.decoders.bp import priors_to_llr
from exp_ldpc_tpu_torch.decoders.bp_int8 import quantize_priors
from exp_ldpc_tpu_torch.decoders.spacetime import SpacetimeCodeSingleShot
from exp_ldpc_tpu_torch.decoders.tanner import TannerELL
from exp_ldpc_tpu_torch.experiments.bench_bsr_shard import build_code
from exp_ldpc_tpu_torch.experiments.bench_large_codes import _qclp_H

ALPHA, ALPHA_NUM = 0.625, 160
# (tag, code, shots, iterations, p, early exit, shot block (None: auto), kernels)
SHAPES = (
    ("S16384", "(H|I)", 16384, 48, 5e-3, False, None, ("K1",)),
    ("S16384_es", "(H|I)", 16384, 48, 5e-3, True, None, ("K1",)),
    ("S685_es", "(H|I)", 685, 48, 5e-3, True, None, ("K1",)),
    ("S685", "(H|I)", 685, 48, 5e-3, False, None, ("K1",)),
    ("bench", "H", 1024, 32, 1e-3, False, None, ("K1",)),
    ("n40000", "hgp40000", 256, 8, 2e-3, False, None, ("K1",)),
    ("cyclic", "cyclic", 1024, 32, 1e-3, False, 128, ("K1", "K5")),
    ("qclp", "qclp", 1024, 32, 1e-3, False, 128, ("K1", "K5")),
)
# (tag, kernel, phase, lane widths): the plan's alternatives, new checkouts
# only; ("route", "grids"): K1 on one grid per phase where it would take its
# cooperative route
VARIANTS = (
    ("S685_es", "K1", "route", "grids"),
    ("S685", "K1", "route", "grids"),
    ("bench", "K1", "route", "grids"),
    ("S16384", "K1", "checks", (2,)),
    ("cyclic", "K1", "variables", (2,)),
    ("cyclic", "K5", "checks", (4,)),
    ("cyclic", "K5", "variables", (4,)),
    ("qclp", "K5", "checks", (8,)),
)


def _matrix(name: str):
    H = biregular_hgp(12, 3, 4, seed=0).checks.z
    if name == "H":
        return H
    if name == "(H|I)":
        return SpacetimeCodeSingleShot(H).spacetime_check_matrix
    if name == "hgp40000":
        return biregular_hgp(160, 3, 4, seed=0).checks.z
    if name == "cyclic":
        return build_code("cyclic4862")
    return _qclp_H()


class _Code:
    def __init__(self, name: str, dev: torch.device):
        H = _matrix(name).tocsr().astype(np.int64)
        self.n = H.shape[1]
        self.layout = bp_bsr.BSRLayout.from_tanner(TannerELL.from_check_matrix(H), dev)
        self.Hs = torch.sparse_csr_tensor(
            torch.as_tensor(H.indptr), torch.as_tensor(H.indices),
            torch.ones(H.nnz, dtype=torch.float32), H.shape).to(dev)
        self.dev = dev

    def batches(self, S: int, p: float, count: int, seed: int):
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(seed)
        out = []
        for _ in range(count):
            err = torch.rand((self.n, S), generator=gen, device=self.dev) < p
            out.append(torch.remainder(self.Hs @ err.to(torch.float32), 2.0).to(torch.uint8))
        return out


def _timed_ms(fn) -> tuple:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _decoders(code: _Code, p: float, iters: int, es: bool, sb: int):
    prior = torch.as_tensor(priors_to_llr(np.full(code.n, p))).to(code.dev)
    prior_q = torch.as_tensor(quantize_priors(prior.cpu().numpy())[0]).to(code.dev)
    lay = code.layout
    return {
        "K1": (bp_bsr.KERNEL,
               lambda s: bp_bsr.bsr_bp_decode(lay, prior, s, "ms", iters, ALPHA, es, sb),
               lambda s: bp_bsr.bsr_bp_plain(lay, prior, s, "ms", iters, ALPHA, es, sb)),
        "K5": (bp_bsr.KERNEL_INT8,
               lambda s: bp_bsr.bsr_bp_decode_int8(lay, prior_q, s, iters, ALPHA_NUM, es, sb),
               lambda s: bp_bsr.bsr_bp_int8_plain(lay, prior_q, s, iters, ALPHA_NUM, es, sb)),
    }


def _with_widths(phase: str, vecs):
    """A context that makes ``bp_bsr``'s plan take ``vecs`` for ``phase``
    (and the route of one grid per phase: cooperative phases have fixed
    widths), or with ``phase`` "route" only the latter."""
    from exp_ldpc_tpu_torch.utils.cuda_build import row_shot_plan

    if phase == "route":
        return mock.patch.object(bp_bsr, "COOPERATIVE", False)
    orig = bp_bsr.bsr_plan

    def plan(C, V, dc, dv, S, sb, sms, int8=False, coop=False):
        pl = orig(C, V, dc, dv, S, sb, sms, int8)
        rows = V if phase == "variables" else C
        return pl._replace(**{phase: row_shot_plan(rows, pl.shots, vecs, sms)})
    return mock.patch.object(bp_bsr, "bsr_plan", plan)


def run_row(code: _Code, shape, kernel: str, runs: int, plain: bool, widths=None) -> dict:
    tag, _name, S, iters, p, es, sb, _kernels = shape
    sb = bp_bsr.auto_shot_block(code.layout) if sb is None else sb
    kern, decode, decode_plain = _decoders(code, p, iters, es, sb)[kernel]
    batches = code.batches(S, p, runs + 1, seed=300)
    rec = {"shape": tag, "kernel": kernel, "shots": S, "iters": iters, "p": p,
           "early_stop": es, "shot_block": sb}
    with ExitStack() as stack:
        if widths is not None:
            stack.enter_context(_with_widths(*widths))
            rec["variant"] = {widths[0]: widths[1]}
        decode(batches[-1])
        kern.reset_counts()
        times, shot_iters = [], []
        for s in batches[:runs]:
            out, ms = _timed_ms(lambda: decode(s))
            times.append(ms)
            shot_iters.append(int(out[3].to(torch.int64).sum()))
        rec["calls_per_decode"] = kern.launches / runs
        rec["routes"] = dict(kern.routes)
    rec["ms"] = float(np.median(times))
    rec["ms_runs"] = times
    rec["shot_iters_mean"] = float(np.mean(shot_iters))
    if plain:
        decode_plain(batches[-1])
        rec["plain_ms"] = float(np.median([_timed_ms(lambda: decode_plain(s))[1]
                                           for s in batches[:runs]]))
    return rec


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--plain", action="store_true", help="time the plain versions too")
    ap.add_argument("--variants", action="store_true",
                    help="re-time some shapes with other lane widths")
    ap.add_argument("--only", default=None, help="comma-separated shape tags")
    ap.add_argument("--write", default=None, metavar="PATH", help="append the rows here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_bsr needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    only = None if args.only is None else set(args.only.split(","))
    codes, rows = {}, []

    def emit(rec):
        rec["card"] = card
        print(json.dumps(rec), flush=True)
        rows.append(rec)

    for shape in SHAPES:
        if only is not None and shape[0] not in only:
            continue
        code = codes.setdefault(shape[1], _Code(shape[1], dev))
        for kernel in shape[7]:
            emit(run_row(code, shape, kernel, args.runs, args.plain))
    if args.variants and hasattr(bp_bsr, "bsr_plan"):
        by_tag = {s[0]: s for s in SHAPES}
        for tag, kernel, phase, vecs in VARIANTS:
            if only is not None and tag not in only:
                continue
            shape = by_tag[tag]
            code = codes.setdefault(shape[1], _Code(shape[1], dev))
            emit(run_row(code, shape, kernel, args.runs, False, (phase, vecs)))
    if args.write:
        with open(args.write, "a") as f:
            for rec in rows:
                f.write(json.dumps(rec) + "\n")
    return rows


if __name__ == "__main__":
    main()
