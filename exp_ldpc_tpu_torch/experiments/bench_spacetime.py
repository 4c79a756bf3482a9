"""Structured vs generic spacetime BP throughput on the card.

    python -m exp_ldpc_tpu_torch.experiments.bench_spacetime [--rounds 4]

Counterpart of ``scripts/bench_spacetime.py``: fixed-iteration min-sum
(32 iterations, alpha 0.625) on HGP-225's (``biregular_hgp(12, 3, 4,
seed=0)``) spacetime program over ``--rounds`` rounds (the script's
``ST_ROUNDS``, default 4), 1,024 shots a batch (``SHOTS``), p = 1e-3: "generic" is flat
BP on the spacetime check matrix (kernel K6, :func:`..decoders.bp_cuda.
bp_fixed`), "structured" the spacetime decoder on the base code (kernel K2,
:func:`..decoders.spacetime_bp_cuda.stbp_fixed`).  Distinct batches (drawn
by ``numpy.random.default_rng(0)`` as the script draws them: 2, then 10),
each time the best of 3 runs of a whole set, the time per batch the slope
between the two set sizes (:func:`slope_time`, as ``bench.py``; where host
noise makes it non-positive, the 10-batch set's time per batch, kind
``upper_bound``, as :func:`.bench_bsr_shard.slope_or_bound` rules).  Beside
each kernel its plain version (``bp_core`` / ``stbp_core`` at fixed
iterations), labelled ``_plain``; the JAX script times its XLA cores, which
have no kernel.  Prints the script's line per decoder and a JSON summary
(``time_kind`` per decoder).
``--device cpu`` runs the plain versions under the kernels' names too.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..codes.hgp import biregular_hgp
from ..convert import tanner_tables
from ..decoders.bp import bp_core, priors_to_llr
from ..decoders.bp_cuda import bp_fixed
from ..decoders.spacetime import SpacetimeCode
from ..decoders.spacetime_bp import stbp_core
from ..decoders.spacetime_bp_cuda import stbp_fixed
from ..decoders.tanner import TannerELL
from ..utils.device import resolve_device
from .bench_bsr_shard import slope_or_bound
from .shard_capacity import _sync, device_name

__all__ = ["make_syndromes", "inputs", "build", "slope_time", "parse_args", "main"]

SHOTS, ITERS, P = 1024, 32, 1e-3
ALPHA = 0.625
N_LO, N_HI = 2, 10


def make_syndromes(rng: np.random.Generator, n_batches: int, shots: int, Hst,
                   p: float) -> np.ndarray:
    """(n_batches, rows, shots) uint8 syndromes of i.i.d. errors at ``p``,
    drawn as the script draws them."""
    errs = (rng.random((n_batches, shots, Hst.shape[1])) < p).astype(np.float32)
    synd = (Hst.astype(np.float32) @ errs.reshape(-1, Hst.shape[1]).T) % 2   # (rows, B*S)
    return np.ascontiguousarray(
        synd.reshape(Hst.shape[0], n_batches, shots).transpose(1, 0, 2).astype(np.uint8))


def inputs(rounds: int, dev: torch.device):
    """(flat tables of the spacetime matrix, tables of the base code, prior
    LLRs, lo batches, hi batches): what both decoders decode."""
    H = biregular_hgp(12, 3, 4, seed=0, compute_logicals=False).checks.z
    r, n = H.shape
    Hst = SpacetimeCode(H, rounds).spacetime_check_matrix.tocsr()
    prior = np.concatenate([np.full((rounds + 1) * n, P), np.full(rounds * r, P)])
    prior_llr = torch.as_tensor(priors_to_llr(prior)).to(dev)
    rng = np.random.default_rng(0)
    lo, hi = ([torch.as_tensor(s).to(dev) for s in make_syndromes(rng, k, SHOTS, Hst, P)]
              for k in (N_LO, N_HI))
    return (tanner_tables(TannerELL.from_check_matrix(Hst), dev),
            tanner_tables(TannerELL.from_check_matrix(H), dev), prior_llr, lo, hi)


def build(args: argparse.Namespace, dev: torch.device):
    """({name: decode of a list of (rows, S) batches -> summed hard bits},
    lo batches, hi batches)."""
    gen, base, prior_llr, lo, hi = inputs(args.rounds, dev)
    R, it = args.rounds, ITERS
    decoders: Dict[str, Callable] = {
        "generic": lambda s: bp_fixed(gen, prior_llr, s, "ms", it, ALPHA),
        "structured": lambda s: stbp_fixed(base, R, prior_llr, s, "ms", it, ALPHA),
        "generic_plain": lambda s: bp_core(gen, prior_llr, s, "ms", it, ALPHA,
                                           early_stop=False),
        "structured_plain": lambda s: stbp_core(base, R, prior_llr, s, "ms", it, ALPHA,
                                                early_stop=False),
    }

    def over_batches(decode):
        def run(batches: List[torch.Tensor]) -> torch.Tensor:
            total = torch.zeros((), dtype=torch.int64, device=dev)
            for s in batches:
                total = total + decode(s)[0].sum()
            return total
        return run

    return {name: over_batches(d) for name, d in decoders.items()}, lo, hi


def slope_time(fn, lo, hi, n_lo: int, n_hi: int, dev: torch.device) -> Tuple[float, str]:
    """(seconds per batch, its kind): (best of 3 at ``hi`` - best of 3 at
    ``lo``) / (n_hi - n_lo), kind "slope", or where that is not positive the
    ``hi`` set's time per batch, kind "upper_bound"."""
    def best(batches):
        times = []
        for _ in range(3):
            _sync(dev)
            t0 = time.perf_counter()
            fn(batches)
            _sync(dev)
            times.append(time.perf_counter() - t0)
        return min(times)

    fn(lo)
    fn(hi)
    t_hi = best(hi)
    return slope_or_bound(best(lo), t_hi, n_lo, n_hi)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (kernels K6 and K2) or cpu (their plain versions)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    fns, lo, hi = build(args, dev)
    out = {"bench": "spacetime", "rounds": args.rounds, "shots": SHOTS, "iters": ITERS, "p": P,
           "device": str(dev), "device_name": device_name(dev), "iter_shots_per_s": {},
           "ms_per_batch": {}, "time_kind": {}}
    for name, fn in fns.items():
        per_batch, kind = slope_time(fn, lo, hi, N_LO, N_HI, dev)
        rate = ITERS * SHOTS / per_batch
        out["iter_shots_per_s"][name] = rate
        out["ms_per_batch"][name] = per_batch * 1e3
        out["time_kind"][name] = kind
        print(f"{name:11s} {rate/1e6:7.1f}M iter*shots/s   ({per_batch*1e3:.1f} ms/batch)",
              flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
