"""K2 (``csrc/stbp.cu``) and K6 (``csrc/bpflat.cu``): routes, plans, sweep.

    python -m exp_ldpc_tpu_torch.experiments.bench_resident [--repeats N] [--no-sweep]
                                                           [--write PATH]

Shapes (min-sum, alpha 0.625, fixed iterations, i.i.d. syndromes at the
flagship's p = 3.48e-3 on the spacetime matrix, 5e-3 on the flat ones):

  * K2 at HGP-225 over 4 rounds, 48 iterations: 16,384 shots (the hybrid
    device step) and 685 (a host redecode's size);
  * K2 at the gross code [[144,12,12]] over 12 rounds, 60 iterations,
    16,384 shots (``scripts/bench_gross.py``'s decoder, batch cut to the
    flagship's);
  * K6 at HGP-225's (H|I), 48 iterations: 16,384 and 685 shots; and at its
    H, 1,024 shots x 32 iterations (``bench_bp``'s shape).

For each shape: the automatic plan (route, shots per block G, threads,
tables in shared memory) and its time (CUDA events, median of
``--repeats`` distinct batches); the streamed route (the 32-shot-block kernel,
kept for shapes whose state does not fit) on the same inputs, with outputs
required bit-identical; the time of one iteration (the fixed cost of
loading syndromes and writing posteriors); and, unless ``--no-sweep``, the
resident kernel over a grid of G caps x threads per block (one block per
SM), over blocks side by side per SM, and with a padded row stride, each
configuration's outputs required equal to the automatic plan's.  One JSON
line per shape; the last line holds all of them with the card's name and
power limit.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..codes.bivariate_bicycle import gross_code
from ..codes.hgp import biregular_hgp
from ..convert import tanner_tables
from ..decoders import bp_cuda as k6
from ..decoders import spacetime_bp_cuda as k2
from ..decoders.bp import priors_to_llr
from ..decoders.spacetime import SpacetimeCode, SpacetimeCodeSingleShot
from ..decoders.tanner import TannerELL
from .bench_grid_barrier import _ms, _syndromes

P_ST, P_FLAT, ALPHA = 2 / 3 * 0.0034822022531844966, 5e-3, 0.625
THREADS = (256, 512, 1024)


def _case(kernel: str, name: str, H, rounds, S, iters, repeats, sweep, dev) -> dict:
    tables = tanner_tables(TannerELL.from_check_matrix(H), dev)
    if kernel == "K2":
        M = SpacetimeCode(H, rounds).spacetime_check_matrix
        p = P_ST

        def plan(**tune):
            return k2.launch_plan(tables, rounds, S, dev, **tune)

        def decode(s, n_iter=iters, plan=None):
            return k2.stbp_fixed(tables, rounds, prior, s, "ms", n_iter, ALPHA, plan=plan)
    else:
        M = H
        p = P_FLAT

        def plan(**tune):
            return k6.launch_plan(tables, S, dev, **tune)

        def decode(s, n_iter=iters, plan=None):
            return k6.bp_fixed(tables, prior, s, "ms", n_iter, ALPHA, plan=plan)
    M = M.tocsr().astype(np.int64)
    prior = torch.as_tensor(priors_to_llr(np.full(M.shape[1], p))).to(dev)
    synds = [_syndromes(M, S, p, 700 + i, dev) for i in range(repeats + 1)]
    auto = plan()
    ref = decode(synds[-1])   # build, warm up
    rec = {"kernel": kernel, "shape": name, "rounds": rounds, "shots": S, "iters": iters,
           "plan": auto._asdict(), "ms": _ms(decode, synds[:-1]),
           "ms_one_iteration": _ms(lambda s: decode(s, 1), synds[:-1]),
           "converged_frac": float(ref[2].float().mean())}

    def same(tag, out):
        if not all(torch.equal(a, b) for a, b in zip(out, ref)):
            raise AssertionError(f"{kernel} {name} {tag}: outputs differ from the automatic plan's")

    if auto.route == "resident":
        st = plan(route="streamed")
        same("streamed route", decode(synds[-1], plan=st))
        rec["ms_streamed"] = _ms(lambda s: decode(s, plan=st), synds[:-1])
    if sweep and auto.route == "resident":
        rows = []
        caps = sorted({auto.group, *(g for g in (1, 2, 3, 4, 6, 8, 11, 16, 21, 32)
                                     if g < auto.group)}, reverse=True)
        configs = [dict(blocks_per_sm=1, max_group=g, threads=t) for g in caps for t in THREADS]
        configs += [dict(blocks_per_sm=b) for b in (1, 2, 4, 8)]
        configs += [dict(pad=1), dict(pad=2)]
        for tune in configs:
            pl = plan(**tune)
            same(f"plan {pl}", decode(synds[-1], plan=pl))
            rows.append({**tune, "group": pl.group, "stride": pl.stride, "blocks": pl.blocks,
                         "threads": pl.threads, "smem_bytes": pl.smem_bytes,
                         "ms": _ms(lambda s: decode(s, plan=pl), synds[:-1])})
        rec["sweep"] = rows
        best = min(rows, key=lambda x: x["ms"])
        rec["best"] = {k: best[k] for k in ("group", "stride", "threads", "ms")}
    return rec


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--no-sweep", action="store_true", help="time the automatic plans only")
    ap.add_argument("--write", type=Path, help="also append the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_resident needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    H = biregular_hgp(12, 3, 4, seed=0, compute_logicals=False).checks.z
    Hss = SpacetimeCodeSingleShot(H).spacetime_check_matrix
    cases = [("K2", "HGP-225", H, 4, 16384, 48), ("K2", "HGP-225", H, 4, 685, 48),
             ("K2", "gross", gross_code().checks.z, 12, 16384, 60),
             ("K6", "(H|I)", Hss, 0, 16384, 48), ("K6", "(H|I)", Hss, 0, 685, 48),
             ("K6", "H", H, 0, 1024, 32)]
    out = []
    for kernel, name, M, rounds, S, iters in cases:
        rec = _case(kernel, name, M, rounds, S, iters, args.repeats, not args.no_sweep, dev)
        rec["device"] = card
        print(json.dumps(rec), flush=True)
        out.append(rec)
        if args.write:
            args.write.parent.mkdir(parents=True, exist_ok=True)
            with args.write.open("a") as f:
                f.write(json.dumps(rec) + "\n")
    print(json.dumps({"card": card, "cases": [
        {k: r[k] for k in ("kernel", "shape", "shots", "iters", "ms", "ms_one_iteration")
         if k in r} | {"ms_streamed": r.get("ms_streamed"), "best": r.get("best")}
        for r in out]}), flush=True)
    return out


if __name__ == "__main__":
    main()
