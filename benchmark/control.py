"""The control of the check: the plain reference put in the program's place,
one precision step down, judged as a run judges the program.

    python3 benchmark/control.py --workload <cell> --seeds <n>[,<n>...]

For each seed it draws as many batches as a run compares (the cell's
``compare_batches``, at the cell's batch size and point) from the
reference's noise model with its uniforms at bfloat16's resolution (8
bits, multiples of 2^-8, in place of float32's 24), decodes them in the
reference's decoders with the device stage's messages in bfloat16 (the
configuration states float32) and the host redecode's in float8 e4m3 (it
states bfloat16), and prints the check's numbers (:mod:`.check`) beside
the cell's limits, one JSON line a seed: every seed has to fail a limit.
Needs a card, as the cell does.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

LOWER = {"float32": "bfloat16", "bfloat16": "float8"}
SAMPLER_BITS = 8


def control_kept(exp, mode, shots: int, batches: int, seed: int, device_precision: str,
                 host_precision: str) -> list:
    """The control's batches in the form the mode's ``compare`` reads."""
    kept = []
    for j in range(batches):
        g = torch.Generator(device=exp.dev)
        g.manual_seed(int(np.random.SeedSequence([int(seed), j]).generate_state(1, np.uint64)[0]
                          >> np.uint64(1)))
        record = exp.sample(shots, g, resolution=SAMPLER_BITS)
        kept.append(mode.control_batch(exp, record, LOWER[device_precision],
                                       LOWER[host_precision]))
    return kept


def control_numbers(root: Path, workload: str, seed: int, device, sizes=None) -> dict:
    from .check import numbers
    from .harness import decode_mode, load, reference_matrices
    from .reference.experiment import Experiment

    _bench, _cell, cfg, traffic = load(root, workload)
    if sizes:
        cfg = {**cfg, **{k: v for k, v in sizes.items() if k in cfg}}
        traffic = {**traffic, **{k: v for k, v in sizes.items() if k in traffic}}
    hx, hz, lz = reference_matrices(cfg, root)
    exp = Experiment(hx, hz, cfg["rounds"], traffic["p"], cfg, device, lz=lz)
    mode = decode_mode(traffic)
    prec = cfg["precision"]
    dev_p, host_p = prec["device_stage"], prec.get("host_redecode", "bfloat16")
    kept = control_kept(exp, mode, int(cfg["shots_per_batch"]), int(traffic["compare_batches"]),
                        seed, dev_p, host_p)
    return numbers(exp, mode, kept, dev_p, host_p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 3
    root = Path(__file__).resolve().parents[1]
    from .harness import load

    limits = load(root, args.workload)[3]["limits"]
    failed_all = True
    for s in args.seeds.split(","):
        nums = control_numbers(root, args.workload, int(s), torch.device("cuda"))
        fails = [k for k, v in nums.items() if limits.get(k) is None or v > limits[k]]
        failed_all &= bool(fails)
        print(json.dumps({"workload": args.workload, "seed": int(s), "numbers": nums,
                          "limits": limits, "fails": fails}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from benchmark.control import main as _main

    sys.exit(_main())
