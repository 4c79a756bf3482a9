"""Gross-code [[144,12,12]] memory benchmark on one card.

    python -m exp_ldpc_tpu_torch.experiments.bench_gross --samples 20000 --rounds 12

Counterpart of ``scripts/bench_gross.py``, with its options, defaults and
rows: the bivariate-bicycle memory experiment (arXiv:2308.07915), N rounds
of syndrome extraction on ``gross_code()``, sampled and decoded on the
device by the pipeline (:class:`..parallel.pipeline.StorageDecodePipeline`:
phenomenological noise, priors 2/3 p, min-sum alpha = 0.625, 60
iterations, ``--samples`` shots in one batch), across ``--p-grid``.  One
warm-up batch (``keys.key_generator(device, 0)``, the script's
``PRNGKey(0)``) before the grid; point i draws from ``key_generator(device,
500 + i)``.  One JSON row per point, with ``ler_per_round``
(:func:`ler_per_round`) and ``shots_per_s``.

The gross code's Z sector lies under the 1 MiB crossover, so the spacetime
stage is kernel K2 (its resident route).  ``--msg-dtype`` is the message
type of the plain spacetime core: as in the JAX package, whose Pallas
kernel ignores it, K2 keeps f32 messages on the card
(``parallel/pipeline.py``'s docstring); ``--device cpu`` runs the plain
core with the given type.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List

import numpy as np

from ..circuits.noise import depolarizing_noise
from ..codes.bivariate_bicycle import gross_code
from ..parallel.pipeline import StorageDecodePipeline
from ..utils.device import resolve_device
from .keys import key_generator
from .p_sweep import parse_sweep_spec

__all__ = ["ler_per_round", "parse_args", "sweep", "main"]


def ler_per_round(failures: int, shots: int, rounds: int) -> float:
    """The per-round logical error rate of a ``rounds``-round LER."""
    return 1 - (1 - failures / shots) ** (1 / rounds)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--samples", type=int, default=20000)
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--p-grid", type=str, default="(1e-3,5e-3,4)")
    ap.add_argument("--max-iter", type=int, default=60)
    ap.add_argument("--msg-dtype", type=str, default="bfloat16")
    ap.add_argument("--device", default="cuda",
                    help="cuda (kernel K2) or cpu (its plain version)")
    return ap.parse_args(argv)


def sweep(args: argparse.Namespace, code=None):
    """(rows, pipeline): the warm-up batch, then one batch per grid point."""
    dev = resolve_device(args.device)
    lo, hi, pts = parse_sweep_spec(args.p_grid)
    p_grid = np.geomspace(lo, hi, pts)
    code = gross_code(compute_logicals=True) if code is None else code
    rows: List[dict] = []
    pipe = None
    for i, p in enumerate(p_grid):
        p = float(p)
        if pipe is None:
            pipe = StorageDecodePipeline(
                code=code, rounds=args.rounds, noise_model=depolarizing_noise(p, p),
                data_prior=2 / 3 * p, meas_prior=2 / 3 * p,
                shots_per_device=args.samples, max_iter=args.max_iter,
                bp_method="ms", ms_scaling_factor=0.625, msg_dtype=args.msg_dtype, device=dev)
            pipe.run(key_generator(dev, 0))   # warm-up: first launches for the whole grid
        else:
            pipe.rebind_noise(depolarizing_noise(p, p), 2 / 3 * p, 2 / 3 * p)
        t0 = time.perf_counter()
        fails, shots, unconv = pipe.run(key_generator(dev, 500 + i))   # ints: synced
        dt = time.perf_counter() - t0
        rows.append({
            "code": "gross_144_12_12", "rounds": args.rounds, "p_ph": p,
            "failures": fails, "samples": shots, "ler": fails / shots,
            "ler_per_round": ler_per_round(fails, shots, args.rounds),
            "bp_unconverged": unconv, "walltime": dt,
            "shots_per_s": shots / dt,
        })
        print(json.dumps(rows[-1], default=float), flush=True)
    return rows, pipe


def main(argv=None) -> int:
    sweep(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
