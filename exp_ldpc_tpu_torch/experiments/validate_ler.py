"""Logical-error-rate validation sweep of the fused pipeline on the card.

    python -m exp_ldpc_tpu_torch.experiments.validate_ler --samples 100000 --decode bposd

Counterpart of ``scripts/validate_ler.py``, with its options, defaults,
rows and exit code.  The device sampler and batched spacetime BP
(:class:`..parallel.pipeline.StorageDecodePipeline`) run the flagship
HGP-225 (``biregular_hgp(12, 3, 4, seed=0)``), 4 rounds, min-sum alpha =
0.625, 48 iterations, across ``--p-grid``; one pipeline serves the grid
(``rebind_noise`` per point), one JSON row per point with its Wilson
interval (z = 2).

  --decode bp     spacetime BP only (``osd_fallback_cap=0``): unconverged
                  shots are hard-decisioned, the row counts them as
                  ``bp_unconverged``.  Cross-check: host ``FrameSampler``
                  records through the same decode (``run_host_sampled``),
                  which isolates the samplers.
  --decode bposd  device BP + host BP+OSD redecode of every BP-unconverged
                  shot, at most ``--osd-cap`` (0: max(256, batch // 4),
                  capped at the batch) a batch; the row counts them as
                  ``osd_decoded``.  Cross-check: ``FrameSampler`` records
                  through the host driver ``BPOSDCorrect`` on every shot,
                  which exercises sampler and decoder.

  --noise pheno   depolarizing data noise and measurement flips, priors 2/3 p;
  --noise circuit DEPOLARIZE2 after two-qubit gates, idle DEPOLARIZE1,
                  measurement flips; data prior p times the circuit depth
                  (:func:`circuit_steps`), measurement prior p.

``--tier1-iters`` runs the pipeline's two-tier decode.  Batch j of point i
draws from ``keys.key_generator(device, 100 + i, j)``, the mapping of the
script's ``fold_in(PRNGKey(100 + i), j)``; cross-check point k samples the
host with seed 999 + k, as the script does.  A rise of the LER against p
beyond the Wilson intervals prints a warning; a cross-check outside 2
pooled sigma exits 1.

On the card the spacetime stage is kernel K3 at HGP-225 (past the 1 MiB
crossover), in the device step and in the host redecode's BP; the pipeline
picks K2 where the JAX rule does.  ``--device cpu`` runs the kernels'
plain versions.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, List, Tuple

import numpy as np
import torch

from ..circuits.noise import circuit_noise, depolarizing_noise
from ..codes.hgp import biregular_hgp
from ..parallel.pipeline import StorageDecodePipeline
from ..sampler.reference import FrameSampler
from ..utils.device import resolve_device
from .keys import key_generator
from .p_sweep import parse_sweep_spec

__all__ = ["wilson_interval", "split_record", "circuit_steps", "make_priors", "osd_cap_for",
           "host_driver_failures", "parse_args", "build_code", "sweep", "crosscheck", "main"]


def wilson_interval(k, n, z=2.0):
    if n == 0:
        return (0.0, 1.0)
    p = k / n
    denom = 1 + z * z / n
    center = (p + z * z / (2 * n)) / denom
    half = z * np.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / denom
    return (max(0.0, center - half), min(1.0, center + half))


def split_record(pipe: StorageDecodePipeline, record: np.ndarray):
    """(S, M) sampler record -> (history (S, rounds, r), readout (S, n)),
    int64, in the pipeline's own record layout (its ``_split_record``)."""
    history, readout = pipe._split_record(torch.as_tensor(np.asarray(record)))
    return (history.cpu().numpy().astype(np.int64), readout.cpu().numpy().astype(np.int64))


def circuit_steps(code) -> int:
    """2q-gate slots a data qubit sees per round: the X and the Z sector's
    larger of max column and max row weight, summed."""
    return max(int(code.checks.x.sum(axis=0).max()), int(code.checks.x.sum(axis=1).max())) + max(
        int(code.checks.z.sum(axis=0).max()), int(code.checks.z.sum(axis=1).max()))


def make_priors(code, noise: str) -> Callable[[float], Tuple[float, float]]:
    """p -> (data prior, measurement prior): circuit noise's depth-aware
    data prior (p times :func:`circuit_steps`) and p, else 2/3 p twice."""
    if noise == "circuit":
        steps = circuit_steps(code)
        return lambda p: (p * steps, p)
    return lambda p: (2 / 3 * p, 2 / 3 * p)


def osd_cap_for(decode: str, batch: int, osd_cap: int) -> int:
    """Shots per batch the host OSD may take: 0 for ``bp``; for ``bposd``
    ``osd_cap`` or max(256, batch // 4), at most the batch."""
    if decode != "bposd":
        return 0
    return min(osd_cap or max(256, batch // 4), batch)


def host_driver_failures(pipe: StorageDecodePipeline, seed: int, shots: int):
    """Independent host chain: ``FrameSampler`` records -> the host BP+OSD
    driver (``BPOSDCorrect``) on every shot -> logical failures."""
    record = FrameSampler(pipe.storage_sim.circuit, seed=seed).sample(shots)
    history, readout = split_record(pipe, record)
    corrector = pipe._osd if pipe._osd is not None else pipe._build_osd_corrector()
    corr = np.asarray(corrector.readout_correction_batch(history, readout), dtype=np.int64)
    flips = ((readout + corr) % 2 @ pipe._Lz_np.T) % 2
    return int(np.any(flips != 0, axis=1).sum()), shots


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--samples", type=int, default=20000)
    ap.add_argument("--batch-shots", type=int, default=0,
                    help="shots per device call (0 = all of --samples in one call)")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--p-grid", type=str, default="(1e-3,8e-3,5)")
    ap.add_argument("--max-iter", type=int, default=48)
    ap.add_argument("--tier1-iters", type=int, default=0,
                    help="two-tier decode: stage-1 iteration budget for every shot; "
                         "unconverged shots redecode at --max-iter (0 = one fixed tier)")
    ap.add_argument("--decode", choices=("bp", "bposd"), default="bp")
    ap.add_argument("--osd-cap", type=int, default=0,
                    help="cap on shots per batch shipped to the host OSD redecode "
                         "(0 = auto: 1/4 of the batch, at least 256)")
    ap.add_argument("--crosscheck-samples", type=int, default=2000)
    ap.add_argument("--crosscheck-points", type=int, default=1,
                    help="cross-check the top-N grid points against the host sampler")
    ap.add_argument("--skip-crosscheck", action="store_true")
    ap.add_argument("--noise", choices=("pheno", "circuit"), default="pheno")
    ap.add_argument("--out", type=str, default=None, help="append JSONL records to this file")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    return ap.parse_args(argv)


def build_code():
    """The flagship HGP-225 with its logicals."""
    return biregular_hgp(12, 3, 4, seed=0, compute_logicals=True)


def sweep(args: argparse.Namespace, code=None):
    """The device sweep: (rows, the pipeline rebound to the last point, the
    grid, the priors).  Prints each row."""
    dev = resolve_device(args.device)
    code = build_code() if code is None else code
    make_noise = circuit_noise if args.noise == "circuit" else depolarizing_noise
    lo, hi, pts = parse_sweep_spec(args.p_grid)
    p_grid = np.geomspace(lo, hi, pts)
    priors = make_priors(code, args.noise)
    batch = args.batch_shots or args.samples
    n_calls = -(-args.samples // batch)
    osd_cap = osd_cap_for(args.decode, batch, args.osd_cap)
    results: List[dict] = []
    pipe = None
    for i, p in enumerate(p_grid):
        dp, mp = priors(p)
        if pipe is None:
            pipe = StorageDecodePipeline(
                code=code, rounds=args.rounds, noise_model=make_noise(p, p),
                data_prior=dp, meas_prior=mp, shots_per_device=batch, max_iter=args.max_iter,
                bp_method="ms", ms_scaling_factor=0.625, osd_fallback_cap=osd_cap,
                tier1_iters=args.tier1_iters, device=dev)
        else:
            pipe.rebind_noise(make_noise(p, p), dp, mp)
        t0 = time.perf_counter()
        fails = shots = unconv = 0
        for j in range(n_calls):
            f, s, u = pipe.run(key_generator(dev, 100 + i, j))   # ints: each call ends synced
            fails, shots, unconv = fails + f, shots + s, unconv + u
        dt = time.perf_counter() - t0
        low, high = wilson_interval(fails, shots)
        rec = {
            "noise": args.noise, "decode": args.decode,
            "p_ph": float(p), "failures": fails, "samples": shots,
            "ler": fails / shots, "ler_ci_low": low, "ler_ci_high": high,
            ("osd_decoded" if args.decode == "bposd" else "bp_unconverged"): unconv,
            "walltime": dt,
        }
        results.append(rec)
        print(json.dumps(rec, default=float), flush=True)
    # monotonicity sanity: the LER should rise with p (within CI overlap)
    if not all(results[i]["ler"] <= results[i + 1]["ler_ci_high"] + 1e-12
               for i in range(len(results) - 1)):
        print("WARNING: LER not monotone within CI", file=sys.stderr)
    return results, pipe, p_grid, priors


def crosscheck(args: argparse.Namespace, results: List[dict], pipe: StorageDecodePipeline,
               p_grid: np.ndarray, priors) -> List[dict]:
    """The top ``--crosscheck-points`` grid points against the host
    sampler; a pooled two-proportion test at 2 sigma per point."""
    make_noise = circuit_noise if args.noise == "circuit" else depolarizing_noise
    checks = []
    for k in range(min(args.crosscheck_points, len(p_grid))):
        idx = len(p_grid) - 1 - k
        p = float(p_grid[idx])
        n = args.crosscheck_samples
        dp, mp = priors(p)
        pipe.rebind_noise(make_noise(p, p), dp, mp)
        if args.decode == "bposd":
            fails_host, n = host_driver_failures(pipe, seed=999 + k, shots=n)
            chain = "host-sampler+BPOSDCorrect"
        else:
            fails_host, n, _u = pipe.run_host_sampled(seed=999 + k, shots=n)
            chain = "host-sampler+device-decode"
        dev = results[idx]
        f1, n1 = dev["failures"], dev["samples"]
        pool = (f1 + fails_host) / (n1 + n)
        sigma = np.sqrt(pool * (1 - pool) * (1 / n1 + 1 / n))
        gap = abs(f1 / n1 - fails_host / n)
        rec = {"noise": args.noise, "decode": args.decode,
               "crosscheck_p": p, "crosscheck_chain": chain,
               "host_failures": fails_host, "host_samples": n,
               "device_ler": f1 / n1, "host_ler": fails_host / n,
               "gap": gap, "two_sigma": 2 * sigma,
               "agree": bool(gap <= 2 * sigma)}
        checks.append(rec)
        print(json.dumps(rec, default=float), flush=True)
    return checks


def main(argv=None) -> int:
    args = parse_args(argv)
    results, pipe, p_grid, priors = sweep(args)
    checks = [] if args.skip_crosscheck else crosscheck(args, results, pipe, p_grid, priors)
    if args.out:
        with open(args.out, "a") as f:
            for r in results + checks:
                f.write(json.dumps(r, default=float) + "\n")
    return 0 if all(c["agree"] for c in checks) else 1


if __name__ == "__main__":
    sys.exit(main())
