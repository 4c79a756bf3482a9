"""f32 against int8 min-sum BP throughput on HGP-225 and the gross code.

Counterpart of ``scripts/bench_int8.py``: :func:`..decoders.bp.bp_core`
(f32) against :func:`..decoders.bp_int8.int8_bp_core` (int8 messages, int32
sums), both plain PyTorch in the gather form, fixed-iteration min-sum at
alpha 0.625.  Method as in :mod:`.bench_large_codes` (a distinct batch per
timed decode, slope over two repeat counts); each row carries the
convergence share of its batches, so the speed ships with an accuracy
signal.  One JSON line per row with the JAX script's keys plus ``device``;
``--write PATH`` writes them to a JSON-lines file.

    python -m exp_ldpc_tpu_torch.experiments.bench_int8
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..codes.bivariate_bicycle import gross_code
from ..codes.hgp import biregular_hgp
from ..convert import tanner_tables
from ..decoders.bp import bp_core, priors_to_llr
from ..decoders.bp_int8 import Int8BPDecoder, int8_bp_core
from ..decoders.tanner import TannerELL
from ..utils.device import resolve_device
from .bench_large_codes import ALPHA, measure, syndrome_source
from .shard_capacity import device_name

__all__ = ["bench", "main"]

REPS_LO, REPS_HI = 8, 64   # decodes per timed sample, as the JAX script


def bench(name, H, *, kind, shots, iters, p, device="cuda") -> dict:
    dev = resolve_device(device)
    tanner = TannerELL.from_check_matrix(H)
    tables = tanner_tables(tanner, dev)
    if kind == "f32":
        prior = torch.as_tensor(priors_to_llr(np.full(tanner.num_vars, p))).to(dev)

        def decode(synd):
            return bp_core(tables, prior, synd, "ms", iters, ALPHA, False)
    else:
        dec8 = Int8BPDecoder.from_check_matrix(H, error_rate=p, max_iter=iters,
                                               ms_scaling_factor=ALPHA, device=dev)
        prior_q, alpha_num = dec8._prior_q, dec8.alpha_num

        def decode(synd):
            return int8_bp_core(tables, prior_q, synd, iters, alpha_num, False)

    per, time_kind, conv_frac, first_s = measure(decode, syndrome_source(H, p, shots, dev),
                                                 REPS_LO, REPS_HI, dev)
    return {
        "code": name,
        "kind": kind,
        "n": tanner.num_vars,
        "shots": shots,
        "iters": iters,
        "p": p,
        "bp_iter_shots_per_s": iters * shots / per,
        "time_kind": time_kind,
        "bp_converged_frac": conv_frac,
        "compile_s": first_s,
        "device": device_name(dev),
    }


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--write", default=None, metavar="PATH")
    ap.add_argument("--shots", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--p", type=float, default=1e-3)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    hgp_H = biregular_hgp(12, 3, 4, seed=0, compute_logicals=False).checks.z
    gross_H = gross_code(compute_logicals=False).checks.z
    out = []
    for name, H in (("hgp_225", hgp_H), ("gross_144_12_12", gross_H)):
        for kind in ("f32", "int8"):
            rec = bench(name, H, kind=kind, shots=args.shots, iters=args.iters, p=args.p,
                        device=args.device)
            print(json.dumps(rec), flush=True)
            out.append(rec)
    if args.write:
        with open(args.write, "w") as f:
            for rec in out:
                f.write(json.dumps(rec) + "\n")
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
