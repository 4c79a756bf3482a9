"""bpd_detector-mode LER campaign: the detector-error-model decode at scale.

    python -m exp_ldpc_tpu_torch.experiments.validate_dem \\
        --p-list 0.0012,0.00079 --samples-list 5120,8192 --out rows.jsonl

Counterpart of ``scripts/validate_dem.py`` on its default path (the relay
ensemble on), with its options, defaults and rows.  Per p, under circuit
noise on HGP-225 (``biregular_hgp(12, 3, 4, seed=0)``), ``--rounds``
rounds:

  1. the device sampler draws detectors with the observables appended
     (``DeviceSampler.sample_detectors``), batch j of point i from
     ``keys.key_generator(device, 300 + i, j)`` (the script's
     ``fold_in(PRNGKey(300 + i), j)``);
  2. stage 1: flat BP on the detector model's fault matrix through
     ``BPDetectorCorrect``'s decoder (``--max-iter``, min-sum, ``--msf``),
     in chunks of :data:`STAGE1_CHUNK` shots;
  3. the unconverged residue (syndromes, observables, stage-1 flips and,
     without relay, stage-1 posteriors) accumulates on the host and is
     redecoded once per point in chunks of ``--relay-cap`` shots by the
     relay ensemble (:class:`..decoders.relay_bp.RelayBPDecoder`,
     ``--relay-legs`` x ``--relay-iters``, alpha 0.625, seed 0);
  4. host OSD-0 (``osd_decode_batch``) of at most ``--osd-cap`` of a
     chunk's shots that relay left unconverged, on the relay posterior;
  5. observable flips of every fault set are computed on the device, as
     the float product with the fault map (exact: 0/1 values, TF32 off).

It does not copy the four faults of the script (ADVICE.md, round 5):

  * without relay (``--relay-legs 0``) OSD orders by the stage-1 BP
    posterior, not by the channel priors;
  * only the relay posterior rows that OSD decodes leave the device;
  * residue shots that miss OSD keep their stage-1 (or relay) flips
    instead of zeros;
  * a ``--samples-list`` whose length differs from the p grid's is an
    argparse error.

Differences from the script, with no effect on any result: the relay
chunks are not padded to ``--relay-cap`` (the script pads for one XLA
compile; a shot's relay decode and its per-shot-freezing stage-1 decode do
not depend on the other shots of the batch), and stage 1 runs in chunks of
:data:`STAGE1_CHUNK` shots for the same reason (the plain core's
(checks x slots x shots) f32 temporaries at 8,192 shots of the 4-round
model would need ~100 GB).

The decoder of stage 1 is the JAX rule's choice (:func:`..decoders.select.
make_bp_decoder`): at 4 rounds the fault matrix is 864 x 36,491 with
checks of 435 slots, and :func:`..decoders.select.fits_bsr` refuses it
(54,750 BSR tiles), so stage 1 is ``BPDecoder`` with per-shot freezing, the
plain core on the card as in the JAX package (no kernel); relay is plain
PyTorch (the JAX relay has no Pallas kernel); OSD runs on the host.
Building the 4-round detector model is ~150 s of host Python
(:func:`point_dem`; it pickles, so a caller may build it elsewhere and pass
it to :func:`run`).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..circuits.noise import circuit_noise
from ..circuits.storage_sim import build_storage_simulation
from ..codes.hgp import biregular_hgp
from ..decoders.dem import detector_error_model
from ..decoders.drivers import BPDetectorCorrect
from ..decoders.osd import osd_decode_batch
from ..decoders.relay_bp import RelayBPDecoder
from ..sampler.device import DeviceSampler
from ..utils.device import resolve_device
from .keys import key_generator
from .p_sweep import parse_sweep_spec
from .validate_ler import wilson_interval

__all__ = ["STAGE1_CHUNK", "parse_args", "point_dem", "DemPoint", "run_point", "run", "main"]

STAGE1_CHUNK = 2048


def parse_args(argv=None) -> argparse.Namespace:
    """The script's options, plus ``--device``; sets ``args.p_values`` and
    ``args.samples_per_point``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--samples", type=int, default=100000)
    ap.add_argument("--batch-shots", type=int, default=8192)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--p-grid", type=str, default="(1.5e-4,1.2e-3,6)")
    ap.add_argument("--p-list", type=str, default=None,
                    help="comma-separated explicit p values (overrides --p-grid)")
    ap.add_argument("--samples-list", type=str, default=None,
                    help="comma-separated per-point sample counts matching the p grid")
    ap.add_argument("--max-iter", type=int, default=48)
    ap.add_argument("--msf", type=float, default=0.0,
                    help="stage-1 min-sum scaling (0 = adaptive)")
    ap.add_argument("--relay-legs", type=int, default=12,
                    help="relay-BP ensemble legs for the stage-2 redecode (0 = skip relay)")
    ap.add_argument("--relay-iters", type=int, default=40)
    ap.add_argument("--relay-cap", type=int, default=2048,
                    help="stage-2 chunk size (shots of the residue per relay decode)")
    ap.add_argument("--osd-cap", type=int, default=2048,
                    help="per-chunk cap on host-OSD redecode of relay-unconverged shots "
                         "(0 = no OSD)")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    args = ap.parse_args(argv)
    if args.p_list:
        args.p_values = np.asarray([float(x) for x in args.p_list.split(",")])
    else:
        lo, hi, pts = parse_sweep_spec(args.p_grid)
        args.p_values = np.geomspace(lo, hi, pts)
    if args.samples_list:
        counts = [int(x) for x in args.samples_list.split(",")]
        if len(counts) != args.p_values.size:
            ap.error(f"--samples-list has {len(counts)} entries but the p grid has "
                     f"{args.p_values.size} points")
        args.samples_per_point = counts
    else:
        args.samples_per_point = [args.samples] * args.p_values.size
    return args


def build_code():
    return biregular_hgp(12, 3, 4, seed=0, compute_logicals=True)


def point_dem(p: float, rounds: int, code):
    """The detector error model of ``code`` under circuit noise at ``p``."""
    sim = build_storage_simulation(rounds, circuit_noise(p, p), code)
    return detector_error_model(sim.circuit)


class DemPoint:
    """One p's circuit, decoders and sampler (``dem``, if given, must be
    :func:`point_dem` of the same p, rounds and code)."""

    def __init__(self, p: float, args: argparse.Namespace, code, device, dem=None):
        self.device = dev = resolve_device(device)
        self.sim = build_storage_simulation(args.rounds, circuit_noise(p, p), code)
        if dem is None:
            dem = detector_error_model(self.sim.circuit)
        self.decoder = BPDetectorCorrect(dem, {
            "max_iter": args.max_iter, "bp_method": "ms", "ms_scaling_factor": args.msf},
            device=dev)
        self.bp = self.decoder._bpd
        self.H = self.decoder._dsc.fault_check_matrix.tocsr()
        self.D, self.F = self.H.shape
        self.relay = None
        if args.relay_legs > 0:
            self.relay = RelayBPDecoder.from_check_matrix(
                self.H, channel_probs=self.decoder._dsc.fault_priors, method="ms",
                ms_scaling_factor=0.625, num_legs=args.relay_legs,
                iters_per_leg=args.relay_iters, seed=0, device=dev)
        self.sampler = DeviceSampler(self.sim.circuit, shots=args.batch_shots, device=dev)
        self._fmap_T = torch.as_tensor(self.decoder._fault_map_T.astype(np.float32)).to(dev)

    def flips(self, fault_sets: torch.Tensor) -> torch.Tensor:
        """(F, S) 0/1 fault sets on the device -> (S, L) int64 observable flips."""
        return torch.remainder(fault_sets.T.to(torch.float32) @ self._fmap_T, 2.0).to(torch.int64)


def _failed(logicals: torch.Tensor, flips: torch.Tensor) -> int:
    return int(((logicals + flips) % 2).any(dim=1).sum())


def run_point(pt: DemPoint, args: argparse.Namespace, i: int, samples: int):
    """Point i's campaign: (its row, seconds in each stage)."""
    dev = pt.device
    n_calls = -(-samples // args.batch_shots)
    times = {"stage1_s": 0.0, "relay_s": 0.0, "osd_s": 0.0}
    t0 = time.perf_counter()
    fails = shots = unconv = relay_n = osd_n = overflow = 0
    res: Dict[str, List[torch.Tensor]] = {"synd": [], "logi": [], "flips": [], "post": []}
    for j in range(n_calls):
        t1 = time.perf_counter()
        rec = pt.sampler.sample_detectors(key_generator(dev, 300 + i, j),
                                          append_observables=True)
        for c0 in range(0, rec.shape[0], STAGE1_CHUNK):
            synd = rec[c0:c0 + STAGE1_CHUNK, :pt.D]
            logi = rec[c0:c0 + STAGE1_CHUNK, pt.D:].to(torch.int64)
            hard, post, conv, _it = pt.bp.decode_tensors(synd.T.contiguous())
            flips = pt.flips(hard)
            unconv += int((~conv).sum())
            fails += _failed(logi[conv], flips[conv])
            uncv = torch.nonzero(~conv).flatten()
            if uncv.numel():
                res["synd"].append(synd[uncv].cpu())
                res["logi"].append(logi[uncv].cpu())
                res["flips"].append(flips[uncv].cpu())
                if pt.relay is None:   # OSD then orders by the stage-1 posterior
                    res["post"].append(post[:, uncv].T.cpu())
        shots += rec.shape[0]
        times["stage1_s"] += time.perf_counter() - t1
    if res["synd"]:
        rs, rl, rf = (torch.cat(res[k]) for k in ("synd", "logi", "flips"))
        rp = torch.cat(res["post"]) if res["post"] else None
        for lo in range(0, rs.shape[0], args.relay_cap):
            sel = slice(lo, min(lo + args.relay_cap, rs.shape[0]))
            k = sel.stop - sel.start
            flips = rf[sel].clone()            # shots OSD does not reach keep these
            t1 = time.perf_counter()
            if pt.relay is not None:
                f2, p2, c2, _leg = pt.relay.decode_tensors(rs[sel].T.contiguous().to(dev))
                flips = pt.flips(f2).cpu()
                conv2 = c2.cpu().numpy()
                relay_n += k
            else:
                conv2 = np.zeros(k, bool)
            times["relay_s"] += time.perf_counter() - t1
            uncv = np.nonzero(~conv2)[0]
            if args.osd_cap > 0 and uncv.size:
                t1 = time.perf_counter()
                o = torch.as_tensor(uncv[: args.osd_cap])
                if pt.relay is not None:   # only the rows OSD decodes leave the device
                    post = p2[:, o.to(dev)].T.cpu().numpy()
                else:
                    post = rp[sel][o].numpy()
                f3 = osd_decode_batch(pt.H, rs[sel][o].numpy(), post, "osd0", 0)
                flips[o] = pt.flips(torch.as_tensor(f3.T.copy()).to(dev)).cpu()
                osd_n += o.numel()
                overflow += uncv.size - o.numel()
                times["osd_s"] += time.perf_counter() - t1
            fails += _failed(rl[sel], flips)
    dt = time.perf_counter() - t0
    low, high = wilson_interval(fails, shots)
    row = {
        "noise": "circuit", "decode": "bpd_detector", "p_ph": float(args.p_values[i]),
        "failures": fails, "samples": shots, "ler": fails / shots,
        "ler_ci_low": low, "ler_ci_high": high,
        "bp_unconverged": unconv, "relay_decoded": relay_n,
        "osd_decoded": osd_n, "osd_overflow": overflow,
        "relay_legs": args.relay_legs,
        "detectors": int(pt.D), "faults": int(pt.F),
        "walltime": dt,
    }
    return row, times


def run(args: argparse.Namespace, code=None, dems: Optional[Dict[float, object]] = None):
    """Every point of the grid: (rows, stage times).  ``dems`` maps a p of
    the grid to its prebuilt :func:`point_dem`."""
    code = build_code() if code is None else code
    rows, times = [], []
    for i, p in enumerate(args.p_values):
        p = float(p)
        pt = DemPoint(p, args, code, args.device, dem=(dems or {}).get(p))
        row, t = run_point(pt, args, i, args.samples_per_point[i])
        rows.append(row)
        times.append(t)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return rows, times


def main(argv=None, code=None) -> int:
    run(parse_args(argv), code)
    return 0


if __name__ == "__main__":
    sys.exit(main())
