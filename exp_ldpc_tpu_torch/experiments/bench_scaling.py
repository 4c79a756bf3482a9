"""Decode-throughput scaling over the data axis (BASELINE.md scaling row).

    python -m exp_ldpc_tpu_torch.experiments.bench_scaling              # the cards, 1..all
    python -m exp_ldpc_tpu_torch.experiments.bench_scaling --virtual 4  # 4 CPU ranks

Counterpart of ``scripts/bench_scaling.py``, with its options, defaults and
rows: sample+decode throughput of the pipeline (HGP-225, ``--rounds``
rounds, phenomenological noise at ``--p``, min-sum alpha = 0.625,
``--max-iter`` iterations, no OSD) on data axes of 1, 2, 4, ... devices up
to the cards present.  The data axis is one process per device
(:mod:`..parallel.mesh`): a mesh of N > 1 runs N ranks joined over NCCL by
:func:`..parallel.mesh.run_world`, each rank sampling and decoding its
``--shots-per-device`` shots, the counts summed over the axis; one device
runs in this process.  Each size runs one warm-up batch, then ``--reps``
timed batches; rank r of a batch draws from ``keys.key_generator(device,
key, r)`` (rank 0 from ``key_generator(device, key)``, the script's
``PRNGKey(key)``), key 0 for the warm-up and i + 1 for batch i.  One row per
size: ``devices``, ``decoded_shots_per_s`` (rank 0's clock) and
``scaling_efficiency`` (:func:`scaling_efficiency`).

``--device cpu`` runs one device on the CPU; ``--virtual N`` runs the
sizes up to N as gloo ranks on the CPU: it checks the sharded program, not
speed (the ranks share one host's cores, so the total rate stays roughly
flat).  On the card the spacetime stage is kernel K3 (HGP-225 is past the
1 MiB crossover).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import List

import torch

from ..circuits.noise import depolarizing_noise
from ..codes.hgp import biregular_hgp
from ..parallel.mesh import make_mesh, run_world
from ..parallel.pipeline import StorageDecodePipeline
from ..utils.device import resolve_device
from .keys import key_generator

__all__ = ["scaling_efficiency", "sizes_for", "measure", "parse_args", "main"]


def scaling_efficiency(rate: float, base: float, devices: int) -> float:
    """Rate on ``devices`` devices over ``devices`` times the one-device rate."""
    return rate / (base * devices)


def sizes_for(n_total: int) -> List[int]:
    return [n for n in (1, 2, 4, 8, 16, 32) if n <= n_total]


def measure(args: argparse.Namespace, devices: int, rank: int = 0) -> float:
    """Decoded shots/s of the pipeline on a data axis of ``devices`` (this
    process is ``rank``; with ``devices`` > 1 inside a joined world)."""
    code = biregular_hgp(12, 3, 4, seed=0, compute_logicals=True)
    mesh = make_mesh(devices, device=args.device) if devices > 1 else None
    pipe = StorageDecodePipeline(
        code=code, rounds=args.rounds, noise_model=depolarizing_noise(args.p, args.p),
        data_prior=2 / 3 * args.p, meas_prior=2 / 3 * args.p,
        shots_per_device=args.shots_per_device, max_iter=args.max_iter,
        bp_method="ms", ms_scaling_factor=0.625, mesh=mesh,
        device=args.device if mesh is None else mesh.device)
    fold = (rank,) if rank else ()
    pipe.run(key_generator(pipe.device, 0, *fold))   # warm-up
    t0 = time.perf_counter()
    shots = 0
    for i in range(args.reps):
        _f, s, _u = pipe.run(key_generator(pipe.device, i + 1, *fold))   # ints: synced
        shots += s
    return shots / (time.perf_counter() - t0)


def _rank(rank: int, world: int, args: argparse.Namespace) -> float:
    return measure(args, world, rank)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--virtual", type=int, default=0,
                    help="use N CPU ranks (gloo) instead of the cards")
    ap.add_argument("--shots-per-device", type=int, default=1024)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--p", type=float, default=3e-3)
    ap.add_argument("--max-iter", type=int, default=32)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the cards, NCCL) or cpu (one device); --virtual implies cpu")
    return ap.parse_args(argv)


def main(argv=None) -> List[dict]:
    args = parse_args(argv)
    if args.virtual:
        args.device, backend, n_total = "cpu", "gloo", args.virtual
    else:
        dev = resolve_device(args.device)
        backend = "nccl"
        n_total = torch.cuda.device_count() if dev.type == "cuda" else 1
    rows, base = [], None
    for n in sizes_for(n_total):
        if n == 1:
            rate = measure(args, 1)
        else:
            rate = run_world(_rank, n, (args,), backend=backend, timeout=900,
                             threads=1 if args.virtual else None)[0]
        base = rate if base is None else base
        rows.append({"devices": n, "decoded_shots_per_s": rate,
                     "scaling_efficiency": scaling_efficiency(rate, base, n)})
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
