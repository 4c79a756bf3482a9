"""Host OSD throughput on realistic BP-failure posteriors.

    python -m exp_ldpc_tpu_torch.experiments.bench_osd_host [--out rows.jsonl]

Counterpart of ``scripts/bench_osd_host.py``, with its options, defaults
and rows.  The bposd contract sends only the BP-unconverged shots to the
host OSD, so a campaign's rate is bounded by host-OSD shots/s at its top
point.  Circuit-noise records of HGP-225 (``biregular_hgp(12, 3, 4,
seed=0)``, ``--rounds`` rounds, ``--p``; ``FrameSampler`` seed 7, the
script's records) are differenced into spacetime syndromes and decoded by
fixed-iteration spacetime BP (``SpacetimeBPDecoder.from_check_matrix(...,
early_stop=False)``, min-sum alpha = 0.625, 48 iterations, the depth-aware
data prior of ``validate_ler``); ``--bench-shots`` of the unconverged shots
(cycled) are then decoded by the port's threaded C++ OSD
(``native/gf2_kernels.cpp::osd_batch`` via ``osd_decode_batch``), methods
``osd0`` and ``osd_cs`` at ``--osd-order``, with 1, 2 and all host
threads: a warm-up on 32 shots, then one timed batch whose every output
must satisfy its syndrome.

The JAX script harvests on the CPU; this one harvests on ``--device``
(the card by default: kernel K2) and says so.  The rows are HOST numbers:
the host's CPU model and core count are printed before them.
``artifacts/osd_host_throughput.jsonl`` holds the JAX script's rows from
another host (2 cores), a record, not a target.
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import time
from typing import List, Tuple

import numpy as np

from ..circuits.noise import circuit_noise
from ..circuits.storage_sim import build_storage_simulation
from ..codes.hgp import biregular_hgp
from ..decoders.osd import osd_decode_batch
from ..decoders.spacetime import SpacetimeCode
from ..decoders.spacetime_bp import SpacetimeBPDecoder
from ..sampler.reference import FrameSampler
from ..utils.device import resolve_device
from .validate_ler import circuit_steps

__all__ = ["host_cpu", "parse_args", "harvest", "time_osd", "main"]


def host_cpu() -> Tuple[str, int]:
    """(CPU model, logical core count) of this host: the model name of
    ``/proc/cpuinfo``, or where it reads "unknown" (some virtual machines hide it)
    its vendor, family, model number and clock."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                if not key.strip():
                    break                       # the first processor's block only
                info.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    model = info.get("model name", "unknown")
    if model == "unknown" and "cpu family" in info:
        model = (f"{info.get('vendor_id', '?')} family {info['cpu family']} model "
                 f"{info.get('model', '?')}, {info.get('cpu MHz', '?')} MHz")
    elif model == "unknown":
        model = platform.processor() or platform.machine()
    return model, os.cpu_count()


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--p", type=float, default=1.2e-3)
    ap.add_argument("--shots", type=int, default=4096,
                    help="sampled shots to harvest BP failures from")
    ap.add_argument("--bench-shots", type=int, default=512,
                    help="OSD batch size per timing run")
    ap.add_argument("--osd-order", type=int, default=7)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the BP harvest runs: cuda (kernel K2) or cpu")
    return ap.parse_args(argv)


def harvest(args: argparse.Namespace):
    """(spacetime matrix, syndromes and posteriors of ``--bench-shots``
    BP-unconverged shots, unconverged count)."""
    code = biregular_hgp(12, 3, 4, seed=0, compute_logicals=True)
    Hz = code.checks.z
    r, n = Hz.shape
    R = args.rounds
    st = SpacetimeCode(Hz, R)
    Hst = st.spacetime_check_matrix.tocsr()
    sim = build_storage_simulation(R, circuit_noise(args.p, args.p), code)
    rec = np.asarray(FrameSampler(sim.circuit, seed=7).sample(args.shots))
    mpr = code.checks.x.shape[0] + r
    hist = rec[:, : mpr * R].reshape(args.shots, R, mpr)[
        :, :, code.checks.x.shape[0]:].astype(np.int64)
    readout = rec[:, mpr * R: mpr * R + n].astype(np.int64)
    synd = st.syndrome_from_history_batch(hist, readout)
    prior = np.concatenate([np.full((R + 1) * n, args.p * circuit_steps(code)),
                            np.full(R * r, args.p)])
    bp = SpacetimeBPDecoder.from_check_matrix(
        Hz, R, channel_probs=prior, max_iter=48, bp_method="ms", ms_scaling_factor=0.625,
        early_stop=False, device=resolve_device(args.device))
    _hard, post, conv, _it = bp.decode_batch(synd)
    fails = np.nonzero(~np.asarray(conv))[0]
    print(f"harvested {len(fails)} BP-unconverged / {args.shots} shots at p={args.p} "
          f"(BP on {args.device})", flush=True)
    if len(fails) == 0:
        raise SystemExit("no BP failures at this p; raise --p")
    idx = fails[np.arange(args.bench_shots) % len(fails)]
    return Hst, synd[idx], np.asarray(post)[idx], len(fails)


def time_osd(Hst, synd_b: np.ndarray, post_b: np.ndarray, args: argparse.Namespace) -> List[dict]:
    """The timed OSD rows (every output checked against its syndrome)."""
    ncpu = os.cpu_count()
    HT = Hst.T.toarray().astype(np.int64)
    rows = []
    for method in ("osd0", "osd_cs"):
        for nthreads in sorted({1, 2, ncpu}):
            # warm once (page-in, lazy csr->dense), then time
            osd_decode_batch(Hst, synd_b[:32], post_b[:32], method, args.osd_order,
                             nthreads=nthreads)
            t0 = time.perf_counter()
            out = osd_decode_batch(Hst, synd_b, post_b, method, args.osd_order,
                                   nthreads=nthreads)
            dt = time.perf_counter() - t0
            if not (((out.astype(np.int64) @ HT) % 2) == synd_b).all():
                raise AssertionError("OSD output violates syndrome")
            rows.append({
                "bench": "osd_host", "matrix": f"hgp225-spacetime-r{args.rounds}",
                "rows": int(Hst.shape[0]), "cols": int(Hst.shape[1]),
                "method": method, "osd_order": args.osd_order,
                "nthreads": nthreads, "host_cores": ncpu,
                "shots": args.bench_shots, "walltime_s": dt,
                "shots_per_s": args.bench_shots / dt,
                "p_source": args.p,
            })
            print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None) -> List[dict]:
    args = parse_args(argv)
    Hst, synd_b, post_b, _n = harvest(args)
    model, cores = host_cpu()
    print(f"host: {model}, {cores} cores (the rows below are host OSD numbers)", flush=True)
    rows = time_osd(Hst, synd_b, post_b, args)
    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return rows


if __name__ == "__main__":
    main()
