"""K2 (``csrc/stbp.cu``) and K6 (``csrc/bpflat.cu``): routes, plans, bounds, sweep.

    python -m exp_ldpc_tpu_torch.experiments.bench_resident [--repeats N] [--no-sweep]
                                                           [--only SUBSTR] [--write PATH]

Shapes (min-sum, alpha 0.625, fixed iterations, i.i.d. syndromes drawn on
the card at the flagship's p = 3.48e-3 (its prior 2/3 of that) on the
spacetime matrix, 5e-3 on the flat ones, unless the shape names its own p):

  * K2 at HGP-225 over 4 rounds, 48 iterations: 16,384 shots (the hybrid
    device step) and 685 (a host redecode's size);
  * K2 at the gross code [[144,12,12]] over 12 rounds, 60 iterations,
    16,384 shots (``scripts/bench_gross.py``'s decoder, batch cut to the
    flagship's);
  * K6 at HGP-225's (H|I), 48 iterations: 16,384 and 685 shots; and at its
    H, 1,024 shots x 32 iterations (``bench_bp``'s shape);
  * the shapes where only a few shots fit a resident block (the selection's
    codes, ``bench_select``): K6 at the cyclic lifted product n = 4,862 and
    HGP n = 10,000 (1 shot a block), the 1-round circuit-noise detector
    model (2), HGP n = 2,025 (5) and n = 1,600 (8), and the HGP codes of
    12-20 slot checks (``bench_select.WIDTH_PROBES``: 1 or 2); K2 at HGP n
    = 1,600 (1) and n = 625 (4) over 4 rounds; 685 and 2,048 shots x 48
    iterations;
  * the streamed shapes (one shot does not fit, or K6's rule streams):
    K6 at HGP n = 40,000 (``biregular_hgp(160, 3, 4, seed=11)``, p = 5e-4)
    at 685, 2,048 and 16,384 shots x 48 and 256 x 8, HGP n = 15,625 at 685
    and 16,384 x 48, the dense HGP's (H|I) (33 slots: route "wide") at
    1,024 x 24; K2 at the cyclic lifted product over 4 rounds at 512 and
    2,048 x 48 (p = 2e-4) and over 8 rounds at 2,048 x 64 (6e-4), HGP n =
    10,000 over 8 rounds at 128 x 32 (3e-4), the dense HGP over 4 rounds (34
    slots) at 1,024 x 24.

For each shape: the automatic plan (route, shots per block G, threads,
tables in shared memory; or the streamed grids) and its time (CUDA events,
median of ``--repeats`` distinct batches); where one shot fits a block, the
other route on the same inputs (``ms_streamed`` or ``ms_resident``), with
outputs required bit-identical; the time of one iteration (the fixed cost
of loading syndromes and writing posteriors); the grids a streamed decode
launches; both bounds of ``utils/bounds.py`` (``on_chip``: inputs and
outputs once; ``device_memory``: the messages to device memory and back
every iteration); and, unless ``--no-sweep``, the resident kernel over a
grid of G caps x threads per block (one block per SM), over blocks side by
side per SM, and with a padded row stride, each configuration's outputs
required equal to the automatic plan's.  One JSON line per shape; the last
line holds all of them with the card's name and power limit.  Needs a CUDA
device.
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
from ..utils.bounds import OPS_FLOAT, bound, flat_io, st_io, streamed_bound
from . import bench_large_codes as fam
from .bench_grid_barrier import _ms
from .bench_select import WIDTH_PROBES, _dem

P_ST, P_FLAT, ALPHA = 2 / 3 * 0.0034822022531844966, 5e-3, 0.625
THREADS = (256, 512, 1024)


def _matrices() -> dict:
    """name -> a function building the check matrix (K2: the base matrix;
    K6: the decoded one)."""
    H225 = lambda: biregular_hgp(12, 3, 4, seed=0, compute_logicals=False).checks.z  # noqa: E731
    dense = lambda: biregular_hgp(32, 16, 16, seed=0).checks.z  # noqa: E731
    out = {"HGP-225": H225, "H": H225, "gross": lambda: gross_code().checks.z,
           "(H|I)": lambda: SpacetimeCodeSingleShot(H225()).spacetime_check_matrix,
           "cyclic_lp_4862": fam._cyclic_H, "hgp_10000": lambda: fam._hgp_H(80, 7),
           "dem_1r": lambda: _dem(1)[0], "hgp_2025": lambda: fam._hgp_H(36, 42),
           "hgp_1600": lambda: fam._hgp_H(32, 42), "hgp_625": lambda: fam._hgp_H(20, 42),
           "hgp_40000": lambda: biregular_hgp(160, 3, 4, seed=11).checks.z,
           "hgp_15625": lambda: biregular_hgp(100, 3, 4, seed=0).checks.z,
           "dense_hgp": dense,
           "dense_hgp_(H|I)": lambda: SpacetimeCodeSingleShot(dense()).spacetime_check_matrix}
    for name, m, dv, dc in WIDTH_PROBES:
        out[name] = lambda m=m, dv=dv, dc=dc: biregular_hgp(m, dv, dc, seed=0).checks.z
    return out


def cases() -> list:
    """(kernel, shape, rounds, shots, iterations, p or None) of every shape."""
    out = [("K2", "HGP-225", 4, 16384, 48, None), ("K2", "HGP-225", 4, 685, 48, None),
           ("K2", "gross", 12, 16384, 60, None),
           ("K6", "(H|I)", 0, 16384, 48, None), ("K6", "(H|I)", 0, 685, 48, None),
           ("K6", "H", 0, 1024, 32, None)]
    few = [("K6", "cyclic_lp_4862", 0), ("K6", "hgp_10000", 0), ("K6", "dem_1r", 0),
           ("K6", "hgp_2025", 0), ("K6", "hgp_1600", 0),
           *(("K6", name, 0) for name, *_ in WIDTH_PROBES),
           ("K2", "hgp_1600", 4), ("K2", "hgp_625", 4)]
    out += [(k, name, rounds, S, 48, None) for k, name, rounds in few for S in (685, 2048)]
    out += [("K6", "hgp_40000", 0, S, it, 5e-4) for S, it in ((685, 48), (2048, 48),
                                                               (16384, 48), (256, 8))]
    out += [("K6", "hgp_15625", 0, S, 48, 5e-4) for S in (685, 16384)]
    out += [("K6", "dense_hgp_(H|I)", 0, 1024, 24, 5e-4),
            ("K2", "cyclic_lp_4862", 4, 512, 48, 2e-4), ("K2", "cyclic_lp_4862", 4, 2048, 48, 2e-4),
            ("K2", "cyclic_lp_4862", 8, 2048, 64, 6e-4), ("K2", "hgp_10000", 8, 128, 32, 3e-4),
            ("K2", "dense_hgp", 4, 1024, 24, 5e-4)]
    return out


def _draw(M, S: int, p: float, seed: int, dev) -> torch.Tensor:
    """(rows, S) uint8 syndromes of i.i.d. faults at rate p, drawn on the card."""
    M = M.tocsr().astype(np.int64)
    Ms = torch.sparse_csr_tensor(torch.as_tensor(M.indptr), torch.as_tensor(M.indices),
                                 torch.ones(M.nnz, dtype=torch.float32), M.shape).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    err = (torch.rand((M.shape[1], S), generator=gen, device=dev) < p).to(torch.float32)
    return torch.remainder(Ms @ err, 2.0).to(torch.uint8)


def _plan_desc(plan) -> dict:
    if plan.route == "resident":
        return plan._asdict()
    return {"route": plan.label, "shots": plan.shots, "checks_vec": plan.checks.vec,
            **{f"{k}_blocks": g.blocks for k, g in (("checks", plan.checks),
                                                    ("variables", plan.variables),
                                                    ("parity", plan.parity))}}


def _case(kernel: str, name: str, H, rounds, S, iters, p, repeats, sweep, dev) -> dict:
    tables = tanner_tables(TannerELL.from_check_matrix(H), dev)
    if kernel == "K2":
        M = SpacetimeCode(H, rounds).spacetime_check_matrix
        p_draw, p_prior = (P_ST, P_ST) if p is None else (p, 2 / 3 * p)

        def plan(**tune):
            return k2.launch_plan(tables, rounds, S, dev, **tune)

        def decode(s, n_iter=iters, plan=None):
            return k2.stbp_fixed(tables, rounds, prior, s, "ms", n_iter, ALPHA, plan=plan)
    else:
        M = H
        p_draw = p_prior = P_FLAT if p is None else p

        def plan(**tune):
            return k6.launch_plan(tables, S, dev, **tune)

        def decode(s, n_iter=iters, plan=None):
            return k6.bp_fixed(tables, prior, s, "ms", n_iter, ALPHA, plan=plan)
    M = M.tocsr()
    prior = torch.as_tensor(priors_to_llr(np.full(M.shape[1], p_prior))).to(dev)
    synds = [_draw(M, S, p_draw, 700 + i, dev) for i in range(repeats + 1)]
    auto = plan()
    ref = decode(synds[-1])   # build, warm up
    io = st_io(*M.shape, tables, S) if kernel == "K2" else flat_io(tables, S)
    rec = {"kernel": kernel, "shape": name, "rounds": rounds, "matrix": list(M.shape),
           "shots": S, "iters": iters, "p": p_draw, "plan": _plan_desc(auto),
           "grids_per_decode": 2 * iters + 1 if auto.route == "streamed" else 1,
           "ms": _ms(decode, synds[:-1]),
           "ms_one_iteration": _ms(lambda s: decode(s, 1), synds[:-1]),
           "converged_frac": float(ref[2].float().mean()),
           "on_chip": bound(io, OPS_FLOAT * M.nnz * S * iters),
           "device_memory": streamed_bound(io, M.shape[0], tables, M.nnz, S, iters)}

    def same(tag, out):
        if not all(torch.equal(a, b) for a, b in zip(out, ref)):
            raise AssertionError(f"{kernel} {name} {tag}: outputs differ from the automatic plan's")

    other = "streamed" if auto.route == "resident" else "resident"
    try:
        alt = plan(route=other)
    except ValueError:   # one shot does not fit: no resident route
        alt = None
    if alt is not None:
        same(f"{other} route", decode(synds[-1], plan=alt))
        rec[f"ms_{other}"] = _ms(lambda s: decode(s, plan=alt), synds[:-1])
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
    ap.add_argument("--only", default=None,
                    help="comma-separated substrings of 'kernel/shape' (e.g. 'K6/cyclic')")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_resident needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    makers, built = _matrices(), {}
    out = []
    for kernel, name, rounds, S, iters, p in cases():
        if args.only and not any(o in f"{kernel}/{name}" for o in args.only.split(",")):
            continue
        if name not in built:
            built[name] = makers[name]()
        rec = _case(kernel, name, built[name], rounds, S, iters, p, args.repeats,
                    not args.no_sweep, dev)
        rec["device"] = card
        print(json.dumps(rec), flush=True)
        out.append(rec)
        if args.write:
            args.write.parent.mkdir(parents=True, exist_ok=True)
            with args.write.open("a") as f:
                f.write(json.dumps(rec) + "\n")
    print(json.dumps({"card": card, "cases": [
        {k: r[k] for k in ("kernel", "shape", "rounds", "shots", "iters", "ms",
                           "ms_one_iteration") if k in r}
        | {k: r.get(k) for k in ("ms_streamed", "ms_resident", "best")}
        | {"bound_ms": r["on_chip"]["bound_ms"], "bound_dm_ms": r["device_memory"]["bound_ms"]}
        for r in out]}), flush=True)
    return out


if __name__ == "__main__":
    main()
