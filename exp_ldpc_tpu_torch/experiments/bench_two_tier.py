"""Fixed against two-tier decode of the bposd pipeline, on the same seeds.

    python -m exp_ldpc_tpu_torch.experiments.bench_two_tier [--out rows.jsonl]

Counterpart of ``scripts/bench_two_tier.py``'s large-code regime: the
cyclic lifted product ``lifted_product_code_cyclic(q=22, m=1, w=14, r=5,
seed=42)`` (n = 4,862), 4 rounds, phenomenological noise at p = 2e-4 with
2/3·p priors, 2,048 shots a batch, min-sum alpha = 0.625, 48 iterations;
the spacetime stage is K3 (the selection's choice: one shot of K2 does not
fit shared memory).  Two variants
on the same generator seeds: "fixed" (every shot 48 iterations) and
"two_tier" (every shot 8 iterations, then the first 512 of the stable
order "unconverged first" redecoded from scratch at 48).  Each variant
runs one warm-up batch (kernel build, first launches) and ``--reps``
timed batches of ``pipeline.run`` (device BP only, no OSD, as the
reference script).  Prints one JSON row per variant (failures, shots,
BP-unconverged shots, wall time, shots/s, ms per batch) and a summary
row; ``--out`` appends them to a file.  The reference rows are in
``artifacts/two_tier_v5e.jsonl``: both variants gave 1,081 failures and
1,131 unconverged shots of 8,192 (the JAX sampler's draws; the port's
device sampler draws others, so its counts agree statistically).

``--device cpu`` with a small ``--shots`` and ``--reps`` runs the same
path on the kernels' plain versions (a check of the script, no timing
claim).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List

import torch

from ..circuits.noise import depolarizing_noise
from ..codes.lifted import lifted_product_code_cyclic
from ..parallel.pipeline import StorageDecodePipeline
from ..utils.device import resolve_device

VARIANTS = ("fixed", "two_tier")


def build_code():
    """The regime's code (with its logicals)."""
    return lifted_product_code_cyclic(q=22, m=1, w=14, r=5, seed=42, compute_logicals=True)


def build(code, variant: str, args: argparse.Namespace) -> StorageDecodePipeline:
    """The pipeline of one variant."""
    p = args.p
    two = dict(tier1_iters=args.tier1, tier2_cap=args.cap) if variant == "two_tier" else {}
    return StorageDecodePipeline(
        code=code, rounds=args.rounds, noise_model=depolarizing_noise(p, p),
        data_prior=2 / 3 * p, meas_prior=2 / 3 * p, shots_per_device=args.shots,
        max_iter=args.max_iter, bp_method="ms", ms_scaling_factor=0.625,
        device=args.device, **two)


def _gen(dev: torch.device, seed: int) -> torch.Generator:
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def run_variant(pipe: StorageDecodePipeline, reps: int, seed: int = 100) -> Dict[str, float]:
    """A warm-up batch, then ``reps`` timed batches on seeds seed, seed+1, ..."""
    dev = pipe.device
    pipe.run(_gen(dev, 0))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fails = shots = unconv = 0
    for k in range(reps):
        f, s, u = pipe.run(_gen(dev, seed + k))   # ints: each batch ends synchronised
        fails, shots, unconv = fails + f, shots + s, unconv + u
    dt = time.perf_counter() - t0
    return {"failures": fails, "shots": shots, "bp_unconverged": unconv, "walltime_s": dt,
            "shots_per_s": shots / dt, "ms_per_batch": 1e3 * dt / reps}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--p", type=float, default=2e-4)
    ap.add_argument("--shots", type=int, default=2048)
    ap.add_argument("--max-iter", type=int, default=48)
    ap.add_argument("--tier1", type=int, default=8)
    ap.add_argument("--cap", type=int, default=512)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    return ap.parse_args(argv)


def compare(pipes: Dict[str, StorageDecodePipeline], args: argparse.Namespace) -> List[dict]:
    """Runs each variant's pipeline; prints (and with ``--out`` appends)
    and returns their rows and the summary."""
    rows, res = [], {}
    for variant in VARIANTS:
        pipe = pipes[variant]
        res[variant] = run_variant(pipe, args.reps)
        rows.append({"bench": "two_tier_large", "code": "cyclic_lp_4862", "rounds": args.rounds,
                     "p": args.p, "mode": variant, "kernel": pipe.kernel,
                     "tier1_iters": args.tier1 if variant == "two_tier" else 0,
                     "tier2_cap": pipe.tier2_cap, "max_iter": args.max_iter,
                     "device": str(args.device),
                     "device_name": (torch.cuda.get_device_name(args.device)
                                     if args.device.type == "cuda" else "cpu"),
                     **res[variant]})
    f, t = res["fixed"], res["two_tier"]
    rows.append({"bench": "two_tier_large_summary", "speedup": f["walltime_s"] / t["walltime_s"],
                 "failures_fixed": f["failures"], "failures_two_tier": t["failures"],
                 "unconv_fixed": f["bp_unconverged"], "unconv_two_tier": t["bp_unconverged"]})
    for row in rows:
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps(row) + "\n")
    return rows


def main(argv=None) -> List[dict]:
    args = parse_args(argv)
    args.device = resolve_device(args.device)
    code = build_code()
    return compare({v: build(code, v, args) for v in VARIANTS}, args)


if __name__ == "__main__":
    main()
