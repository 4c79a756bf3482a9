"""Check-partition BP (kernel K4) against K1 on one device, per iteration.

Counterpart of ``scripts/bench_bsr_shard.py``, with its codes, seeds and
defaults: ``cyclic4862`` (the lifted product ``lifted_product_code_cyclic(
q=22, m=1, w=14, r=5, seed=42)``, Z checks in its QC order), ``hgp625`` and
``hgp10000``; 1,024 shots at p = 1e-3, 32 min-sum iterations, D in the
``--shards`` list.  For each D the D shards run in order on one device
(emulation: everything a D-device decode computes except the all-reduce,
whose bytes per rank and iteration, 2(D-1)/D * 4 * V_pad * S, are
reported beside it).  The reference line is K1 at fixed iterations
(min-sum, alpha 0.625), the unsharded decode.  Each time is a slope over
two repeat counts (``--reps-lo``/``--reps-hi`` decodes of distinct
batches, best of 3, CUDA-synchronised), so fixed per-call costs cancel.
One JSON line per configuration.

    python -m exp_ldpc_tpu_torch.experiments.bench_bsr_shard --code cyclic4862 --shards 1,2,4
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Tuple

import numpy as np
import torch
from scipy import sparse

from ..codes.hgp import biregular_hgp
from ..codes.lifted import lifted_product_code_cyclic
from ..decoders.tanner import TannerELL
from ..decoders.bp import priors_to_llr
from ..decoders.bp_bsr import BSRLayout, auto_shot_block, bsr_bp_decode
from ..decoders.bp_bsr_shard import ShardedBSR, ShardedBSRDecoder, allreduce_bytes
from ..utils.device import resolve_device
from .shard_capacity import _sync, device_name

__all__ = ["build_code", "slope_time", "slope_or_bound", "main"]


def build_code(name: str) -> sparse.csr_matrix:
    if name == "hgp625":
        return biregular_hgp(20, 3, 4, seed=1, compute_logicals=False).checks.z.tocsr()
    if name == "hgp10000":
        return biregular_hgp(80, 3, 4, seed=7, compute_logicals=False).checks.z.tocsr()
    if name == "cyclic4862":
        code = lifted_product_code_cyclic(q=22, m=1, w=14, r=5, seed=42,
                                                       compute_logicals=False)
        meta = code.qc_meta
        # QC order: checks and qubits by circulant block
        return sparse.csr_matrix(code.checks.z)[meta.z_check_perm][:, meta.qubit_perm]
    raise ValueError(f"unknown code {name!r}")


def slope_time(decode, make_batch, reps_lo: int, reps_hi: int, dev: torch.device,
               nrep: int = 3) -> Tuple[float, str]:
    """(seconds per decode, its kind).  The time is the slope
    (T(reps_hi) - T(reps_lo)) / (reps_hi - reps_lo), each T the best of
    ``nrep`` runs of that many decodes of distinct batches: kind "slope".
    Where the host's timing noise swamps that difference (a tiny decode on
    a loaded CPU: a slope at or below 0, which no decode takes), it is
    T(reps_hi) / reps_hi with the fixed per-run costs in, and the kind is
    "upper_bound"; every row that reports the time carries the kind."""
    los = [[make_batch() for _ in range(reps_lo)] for _ in range(nrep)]
    his = [[make_batch() for _ in range(reps_hi)] for _ in range(nrep)]

    def run(batches):
        _sync(dev)
        t0 = time.perf_counter()
        for b in batches:
            decode(b)
        _sync(dev)
        return time.perf_counter() - t0

    run(los[0])
    run(his[0])
    return slope_or_bound(min(run(x) for x in los), min(run(x) for x in his), reps_lo, reps_hi)


def slope_or_bound(t_lo: float, t_hi: float, n_lo: int, n_hi: int) -> Tuple[float, str]:
    """(seconds per decode, its kind) from the times of ``n_lo`` and ``n_hi``
    decodes: the slope, kind "slope", where it is positive, else ``t_hi /
    n_hi`` with the fixed costs in, kind "upper_bound"."""
    slope = (t_hi - t_lo) / (n_hi - n_lo)
    return (slope, "slope") if slope > 0 else (t_hi / n_hi, "upper_bound")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--code", default="hgp625")
    ap.add_argument("--shards", default="1,2")
    ap.add_argument("--shots", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--reps-lo", type=int, default=4)
    ap.add_argument("--reps-hi", type=int, default=16)
    ap.add_argument("--p", type=float, default=1e-3)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    H = build_code(args.code)
    C, V = H.shape
    S, iters = args.shots, args.iters
    rng = np.random.default_rng(0)
    prior_llr = priors_to_llr(np.full(V, args.p))

    def make_batch():
        err = (rng.random((S, V)) < args.p).astype(np.uint8)
        return torch.as_tensor((H @ err.T % 2).astype(np.uint8)).to(dev)

    base = {"code": args.code, "n": V, "checks": C, "shots": S, "iters": iters,
            "device": device_name(dev)}
    layout = BSRLayout.from_tanner(TannerELL.from_check_matrix(H), dev)
    prior = torch.as_tensor(prior_llr).to(dev)
    sb = auto_shot_block(layout)
    per_decode, kind = slope_time(
        lambda s: bsr_bp_decode(layout, prior, s, "ms", iters, 0.625, False, sb),
        make_batch, args.reps_lo, args.reps_hi, dev)
    print(json.dumps({**base, "config": "k1_fixed", "shot_block": sb, "time_kind": kind,
                      "per_iter_s": per_decode / iters,
                      "iter_shots_per_s": iters * S / per_decode}), flush=True)
    for D in (int(x) for x in args.shards.split(",")):
        sb = ShardedBSR.from_check_matrix(H, D)
        dec = ShardedBSRDecoder(sb, prior_llr, method="ms", max_iter=iters, device=dev)
        per_decode, kind = slope_time(lambda s: dec.decode_tensors(s), make_batch,
                                      args.reps_lo, args.reps_hi, dev)
        per_iter = per_decode / iters
        print(json.dumps({**base, "config": f"shard{D}", "shards": D, "time_kind": kind,
                          "per_iter_s_all_shards": per_iter, "per_iter_s_per_shard": per_iter / D,
                          "iter_shots_per_s_equiv": iters * S / per_decode,
                          "allreduce_bytes_per_iter": allreduce_bytes(D, sb.v_pad, S)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
