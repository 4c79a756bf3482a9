"""Long-stream sliding-window decode demo on the card.

    python -m exp_ldpc_tpu_torch.experiments.demo_sliding_window [--out rows.jsonl]

Counterpart of ``scripts/demo_sliding_window.py``, with its options,
defaults and rows: a long memory experiment on HGP-225 (``biregular_hgp(12,
3, 4, seed=0)``, phenomenological noise at ``--p``, ``--shots`` shots from
the device sampler, ``keys.key_generator(device, 1)`` for the script's
``PRNGKey(1)``) decoded by :class:`..decoders.sliding_window.
SlidingWindowDecoder` in O(window) memory: windows of ``--window`` rounds
committed ``--commit`` at a time, min-sum alpha = 0.625, 48 iterations, BP+OSD
(OSD-CS order 7) per window.  The decoder is warmed on a ``2 * window``-round
prefix (the window and the tail decoder); then the whole stream is decoded
and timed.  One row per round count (``--rounds``), and with two or more
the ``sliding_window_scaling`` row: the walltime ratio over the rounds
ratio of the first two (:func:`walltime_ratio`; 1 is a constant cost per
round).

On the card the window's and the tail's BP is the selection's kernel K1
with its exit armed (BP+OSD asks the exit): 31 calls per 64-round stream
at window 4, commit 2 (30 windows and the tail); OSD runs on the host.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import numpy as np

from ..circuits.noise import depolarizing_noise
from ..circuits.storage_sim import build_storage_simulation
from ..codes.hgp import biregular_hgp
from ..decoders.sliding_window import SlidingWindowDecoder, window_check_matrix
from ..sampler.device import DeviceSampler
from ..utils.device import resolve_device
from .keys import key_generator

__all__ = ["run", "walltime_ratio", "main"]


def run(rounds: int, shots: int, p: float, window: int, commit: int, out: Optional[str],
        device="cuda", code=None) -> dict:
    """One round count: sample, warm the decoder, decode and time the
    stream; prints (and with ``out`` appends) and returns the row."""
    dev = resolve_device(device)
    code = biregular_hgp(12, 3, 4, seed=0, compute_logicals=True) if code is None else code
    Hz = code.checks.z
    r, n = Hz.shape
    x_count = code.checks.x.shape[0]
    mpr = x_count + r
    Lz = np.asarray(code.logicals.z, dtype=np.int64)

    sim = build_storage_simulation(rounds, depolarizing_noise(p, p), code)
    sampler = DeviceSampler(sim.circuit, shots=shots, device=dev)
    t0 = time.perf_counter()
    rec = sampler.sample(key_generator(dev, 1)).cpu().numpy()
    t_sample = time.perf_counter() - t0
    hist = rec[:, : mpr * rounds].reshape(shots, rounds, mpr)[:, :, x_count:].astype(np.int64)
    readout = rec[:, mpr * rounds: mpr * rounds + n].astype(np.int64)

    dec = SlidingWindowDecoder(
        Hz, 2 / 3 * p, 2 / 3 * p, window=window, commit=commit,
        bp_options=dict(max_iter=48, bp_method="ms", ms_scaling_factor=0.625), device=dev)
    # warm the two decoders (window and tail) on a short prefix
    dec.decode_batch(hist[:, : 2 * window], readout)

    t0 = time.perf_counter()
    corr = dec.decode_batch(hist, readout)   # numpy out: the card is synced
    dt = time.perf_counter() - t0
    corrected = (readout + np.asarray(corr, dtype=np.int64)) % 2
    fails = int((((corrected @ Lz.T) % 2) != 0).any(axis=1).sum())

    Hw = window_check_matrix(Hz, window)
    rec_out = {
        "bench": "sliding_window", "code": "hgp225", "rounds": rounds,
        "shots": shots, "p": p, "window": window, "commit": commit,
        "window_matrix": list(Hw.shape),
        "full_spacetime_cols": (rounds + 1) * n + rounds * r,
        "sample_walltime_s": t_sample,
        "decode_walltime_s": dt,
        "decode_ms_per_round_per_kshot": dt / rounds / shots * 1e3 * 1000,
        "failures": fails, "ler": fails / shots,
    }
    print(json.dumps(rec_out), flush=True)
    if out:
        with open(out, "a") as f:
            f.write(json.dumps(rec_out) + "\n")
    return rec_out


def walltime_ratio(r0: dict, r1: dict) -> float:
    """Decode walltime ratio over rounds ratio of two rows (1 = linear in rounds)."""
    return (r1["decode_walltime_s"] / r0["decode_walltime_s"]) / (r1["rounds"] / r0["rounds"])


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shots", type=int, default=512)
    ap.add_argument("--p", type=float, default=1e-3)
    ap.add_argument("--window", type=int, default=4)
    ap.add_argument("--commit", type=int, default=2)
    ap.add_argument("--rounds", type=str, default="64,128")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (kernel K1) or cpu (its plain version)")
    return ap.parse_args(argv)


def main(argv=None, code=None) -> List[dict]:
    """Every round count's row, then the scaling row (with two or more)."""
    args = parse_args(argv)
    recs = [run(int(rr), args.shots, args.p, args.window, args.commit, args.out,
                device=args.device, code=code)
            for rr in args.rounds.split(",")]
    if len(recs) >= 2:
        row = {"bench": "sliding_window_scaling",
               "walltime_ratio_vs_rounds_ratio": walltime_ratio(recs[0], recs[1])}
        print(json.dumps(row))
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        recs.append(row)
    return recs


if __name__ == "__main__":
    main()
