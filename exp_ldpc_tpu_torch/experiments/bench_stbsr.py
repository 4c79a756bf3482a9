"""K3 (spacetime BP, ``csrc/stbsr.cu``): per decode and per phase, the
script's throughput record, and its LER chain on a large code.

    python -m exp_ldpc_tpu_torch.experiments.bench_stbsr                  # per phase (card)
    python -m exp_ldpc_tpu_torch.experiments.bench_stbsr --iters 8,32 [--only cyclic_lp_4862]
    python -m exp_ldpc_tpu_torch.experiments.bench_stbsr --ler [--ler-shots 2048] [--out PATH]

Counterpart of ``scripts/bench_stbsr.py``, in three modes:

  * per phase (no ``--iters``, no ``--ler``; needs a card): the script's two
    large codes (the cyclic lifted product n = 4,862 and
    ``biregular_hgp(80, 3, 4, seed=7)`` n = 10,000; 8 rounds, 128 shots, 32
    iterations, p = 1e-3) and the flagship's shapes (HGP-225, 4 rounds, 48
    iterations, 16,384 shots: the ``bposd`` device step; 685 shots: its host
    redecode).  For each shape and method it times ``stbsr_decode`` (CUDA
    events, median of ``--repeats`` distinct batches, fixed iterations) and
    traces one more decode with ``torch.profiler`` to split the device time
    over the three grids of an iteration (checks, variables, parity).  One
    JSON line per case; the last line holds all of them with the card's name
    and power limit.
  * ``--iters lo,hi`` (the script's default mode): for each code of
    ``--only`` (default both), ``--rounds`` rounds and ``--shots`` shots,
    min-sum 0.625 at p = 1e-3, fixed iterations: the time per decode at
    both budgets (six distinct batches, dispatched together, one
    synchronisation), the slope between them, and the script's record
    (``per_iter_ms``, ``iter_shots_per_s``, ``decoded_shots_per_s_at32``,
    ...).  ``tiles`` and ``shot_block`` (the TPU kernel's BSR tiling) are
    null: K3 has neither, and ``plan`` gives its lanes and grids instead.
  * ``--ler`` (:func:`ler_chain`): the script's ``ler_sanity``, the composed
    chain on the cyclic n = 4,862 code over ``--rounds`` rounds: device
    sampler (``PRNGKey(10 + i)`` mapped by :mod:`.keys`) -> differenced
    spacetime syndromes -> K3 with the global exit armed (64 min-sum
    iterations, alpha 0.625, priors 2/3 p on every column) -> final
    correction -> logical test, at p = 3e-4, 6e-4, 1.2e-3, ``--ler-shots``
    shots each; one row per p with the script's keys, and the script's
    assertion that the LER grows with p.  Its anchor is
    ``artifacts/stbsr_ler_v5e.jsonl``.

``--out`` appends each record to a JSON-lines file (any path).  Every mode
runs on the card unless ``--device cpu`` is given; the per-phase mode runs
only there.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from functools import lru_cache
from typing import Callable, List, Optional

import numpy as np
import torch

from ..circuits.noise import depolarizing_noise
from ..circuits.storage_sim import build_storage_simulation
from ..codes.hgp import biregular_hgp
from ..codes.lifted import lifted_product_code_cyclic
from ..convert import tanner_tables
from ..decoders.bp import priors_to_llr
from ..decoders.bp_bsr_spacetime import SpacetimeBSRDecoder, launch_plans, stbsr_decode
from ..decoders.spacetime import SpacetimeCode
from ..decoders.tanner import TannerELL
from ..sampler.device import DeviceSampler
from ..utils.device import resolve_device
from .bench_grid_barrier import _ms, _syndromes
from .keys import key_generator

_PHASES = {"stbsr_check_kernel": "checks_ms", "stbsr_var_kernel": "variables_ms",
           "stbsr_parity_kernel": "parity_ms"}
# the LER chain's settings (scripts/bench_stbsr.py:125-181)
LER_PS = (3e-4, 6e-4, 1.2e-3)
LER_KEY = 10          # PRNGKey(10 + i) for the i-th p
LER_ITERS, LER_ALPHA = 64, 0.625


@lru_cache(maxsize=None)
def _cyclic(logicals: bool = False):
    return lifted_product_code_cyclic(q=22, m=1, w=14, r=5, seed=42,
                                      compute_logicals=logicals)


@lru_cache(maxsize=None)
def _hgp10000():
    return biregular_hgp(80, 3, 4, seed=7, compute_logicals=False)


CASES = {"cyclic_lp_4862": lambda: _cyclic().checks.z,
         "hgp_10000": lambda: _hgp10000().checks.z}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _emit(rec: dict, out: Optional[str]) -> None:
    print(json.dumps(rec), flush=True)
    if out:
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")


# ---------------------------------------------------------------------------
# per phase (the card only)
# ---------------------------------------------------------------------------

def _case(name, H, rounds, S, iters, p, method, msf, repeats, dev) -> dict:
    tables = tanner_tables(TannerELL.from_check_matrix(H), dev)
    Hst = SpacetimeCode(H, rounds).spacetime_check_matrix.tocsr().astype(np.int64)
    prior = torch.as_tensor(priors_to_llr(np.full(Hst.shape[1], p))).to(dev)
    synds = [_syndromes(Hst, S, p, 100 + i, dev) for i in range(repeats + 1)]

    def decode(s):
        return stbsr_decode(tables, rounds, prior, s, method, iters, msf, False)

    decode(synds[-1])   # build, warm up
    rec = {"shape": name, "rounds": rounds, "shots": S, "iters": iters, "method": method,
           "check_degree": tables.max_check_degree, "var_degree": tables.max_var_degree,
           "decode_ms": _ms(decode, synds[:-1])}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        conv = decode(synds[0])[2]
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        for kernel, key in _PHASES.items():
            if kernel in ev.key:
                rec[key] = rec.get(key, 0.0) + ev.device_time_total / 1e3
    rec["converged_frac"] = float(conv.float().mean())
    return rec


def per_phase(repeats: int, dev: torch.device) -> List[dict]:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    hgp225 = biregular_hgp(12, 3, 4, seed=0, compute_logicals=False).checks.z
    large = {"cyclic n=4862": CASES["cyclic_lp_4862"](), "HGP n=10000": CASES["hgp_10000"]()}
    p_flag = 2 / 3 * 0.0034822022531844966
    cases = [("HGP-225", hgp225, 4, S, 48, p_flag, "ms", 0.625) for S in (16384, 685)]
    cases += [(name, H, 8, 128, 32, 1e-3, method, msf) for name, H in large.items()
              for method, msf in (("ms", 0.625), ("ps", 0.0))]
    rows = []
    for case in cases:
        rows.append(_case(*case, repeats, dev))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"card": card, "rows": rows}), flush=True)
    return rows


# ---------------------------------------------------------------------------
# the script's throughput record (scripts/bench_stbsr.py:46-122)
# ---------------------------------------------------------------------------

def bench_decode(name: str, H, rounds: int, shots: int, iters_lo: int, iters_hi: int,
                 out: Optional[str], dev: torch.device, reps: int = 6) -> dict:
    r, n = H.shape
    Hst = SpacetimeCode(H, rounds).spacetime_check_matrix.tocsr()
    n_st = Hst.shape[1]
    p = 1e-3

    def synd_batch(seed):
        # sparse spacetime matvec, as the script (the dense operator is ~11 GB at n=10000)
        rng = np.random.default_rng(seed)
        err = (rng.random((shots, n_st)) < p).astype(np.int64)
        return np.asarray((Hst @ err.T).T % 2).astype(np.uint8)

    dec, compile_s = {}, {}
    for it in (iters_lo, iters_hi):
        dec[it] = SpacetimeBSRDecoder.from_check_matrix(
            H, rounds, error_rate=p, max_iter=it, bp_method="ms", ms_scaling_factor=0.625,
            early_stop=False, device=dev)
        t0 = time.perf_counter()
        dec[it].decode_batch(synd_batch(999))  # build + run once
        compile_s[it] = time.perf_counter() - t0

    # validity on the warm-up batch of the hi-iters decoder
    sb = synd_batch(999)
    hard, _post, conv, _i = dec[iters_hi].decode_batch(sb)
    par = np.asarray((Hst @ hard.astype(np.int64).T).T % 2)
    if not ((par == sb).all(axis=1) == conv).all():
        raise AssertionError("convergence flags are not honest")

    # timed repeats: distinct inputs, one synchronisation at the end
    times = {}
    for it in (iters_lo, iters_hi):
        batches = [torch.as_tensor(synd_batch(100 + k).T.copy()).to(dev) for k in range(reps)]
        d = dec[it]

        def decode(b, d=d, it=it):
            return stbsr_decode(d.tables, d.num_rounds, d._prior, b, d.method, it,
                                d.ms_scaling_factor, False)
        decode(batches[0])   # warm
        _sync(dev)
        t0 = time.perf_counter()
        for b in batches:
            decode(b)
        _sync(dev)
        times[it] = (time.perf_counter() - t0) / reps

    per_iter_s = (times[iters_hi] - times[iters_lo]) / (iters_hi - iters_lo)
    plan = None
    if dev.type == "cuda":
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plans = launch_plans(dec[iters_hi].tables, rounds, shots, sms)._asdict()
        plan = {phase: {"route": pl.route, "vec": pl.vec, "blocks": pl.blocks}
                for phase, pl in plans.items()}
    rec = {
        "bench": "stbsr", "code": name, "n": n, "r": r, "rounds": rounds,
        "n_spacetime": n_st, "shots": shots, "tiles": None, "shot_block": None,
        "iters_lo": iters_lo, "iters_hi": iters_hi,
        "t_lo_s": times[iters_lo], "t_hi_s": times[iters_hi],
        "per_iter_ms": per_iter_s * 1e3,
        "iter_shots_per_s": shots / per_iter_s,
        "decoded_shots_per_s_at32": shots / (times[iters_lo] + per_iter_s * (32 - iters_lo)),
        "compile_s_lo": compile_s[iters_lo], "compile_s_hi": compile_s[iters_hi],
        "conv_frac_warmup": float(conv.mean()), "p": p, "plan": plan,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    _emit(rec, out)
    return rec


# ---------------------------------------------------------------------------
# the LER chain (scripts/bench_stbsr.py:125-181)
# ---------------------------------------------------------------------------

def device_records(sim, shots: int, key: int, dev: torch.device) -> torch.Tensor:
    """(shots, M) uint8 records of ``sim``'s circuit from the device
    sampler, drawn from the counterpart of ``PRNGKey(key)``."""
    return DeviceSampler(sim.circuit, shots=shots, device=dev).sample(key_generator(dev, key))


def spacetime_syndromes(HzT: torch.Tensor, history: torch.Tensor,
                        readout: torch.Tensor) -> torch.Tensor:
    """``SpacetimeCode.syndrome_from_history_batch`` on the device,
    transposed: history (S, R, r) and readout (S, n) 0/1 floats ->
    ((R+1)·r, S) uint8.  The readout's parity is a float product of 0/1
    values, exact (sums <= n < 2^24; TF32 is off)."""
    S = history.shape[0]
    synd = torch.cat([history, torch.remainder(readout @ HzT, 2.0)[:, None]], dim=1)
    synd[:, 1:] = torch.remainder(synd[:, 1:] + synd[:, :-1], 2.0)
    return synd.reshape(S, -1).T.to(torch.uint8).contiguous()


def logical_failures(rounds: int, hard: torch.Tensor, readout: torch.Tensor,
                     LzT: torch.Tensor) -> torch.Tensor:
    """(S,) bool: the final correction (``SpacetimeCode.final_correction``:
    the mod-2 sum of the decision's rounds+1 data blocks) plus the readout
    anticommutes with some Z logical.  ``hard`` ((R+1)·n + R·r, S) as K3
    returns it; the logical product is exact as the syndromes'."""
    n = readout.shape[1]
    B = rounds + 1
    corr = hard[: B * n].view(B, n, -1).to(torch.float32).sum(dim=0)      # (n, S)
    corrected = torch.remainder(readout + corr.T, 2.0)                     # (S, n)
    return (torch.remainder(corrected @ LzT, 2.0) != 0).any(dim=1)


def ler_chain(shots: int = 2048, rounds: int = 8, device="cuda", *, code=None,
              records: Callable = device_records, out: Optional[str] = None,
              inputs: Optional[list] = None) -> List[dict]:
    """The script's ``ler_sanity`` on ``code`` (default: the cyclic lifted
    product n = 4,862 with its logicals); one row per p of :data:`LER_PS`.
    ``records(sim, shots, key, dev)`` gives the measurement records
    (default :func:`device_records`).  If ``inputs`` is a list, each point's
    (decoder, syndromes) is appended to it."""
    dev = resolve_device(device)
    name = "cyclic_lp_4862" if code is None else f"n{code.checks.z.shape[1]}"
    code = _cyclic(logicals=True) if code is None else code
    Hz = code.checks.z
    r, n = Hz.shape
    x_count = code.checks.x.shape[0]
    mpr = x_count + r
    HzT = torch.as_tensor(Hz.T.toarray(), dtype=torch.float32).to(dev)
    LzT = torch.as_tensor(np.array(code.logicals.z, dtype=np.float32).T).to(dev)
    rows = []
    for i, p in enumerate(LER_PS):
        sim = build_storage_simulation(rounds, depolarizing_noise(p, p), code)
        rec = records(sim, shots, LER_KEY + i, dev).to(dev, torch.float32)
        hist = rec[:, : mpr * rounds].reshape(shots, rounds, mpr)[:, :, x_count:]
        readout = rec[:, mpr * rounds: mpr * rounds + n]
        synd = spacetime_syndromes(HzT, hist, readout)
        dec = SpacetimeBSRDecoder.from_check_matrix(
            Hz, rounds, channel_probs=np.concatenate([
                np.full((rounds + 1) * n, 2 / 3 * p), np.full(rounds * r, 2 / 3 * p)]),
            max_iter=LER_ITERS, bp_method="ms", ms_scaling_factor=LER_ALPHA, early_stop=True,
            device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        hard, _post, conv, iters = dec.decode_tensors(synd)
        _sync(dev)
        dt = time.perf_counter() - t0
        fails = int(logical_failures(rounds, hard, readout, LzT).sum())
        row = {"bench": "stbsr_ler", "code": name, "rounds": rounds, "p": p, "shots": shots,
               "failures": fails, "ler": fails / shots, "bp_unconverged": int((~conv).sum()),
               "iters": int(iters[0]), "decode_walltime_s": dt}
        rows.append(row)
        _emit(row, out)
        if inputs is not None:
            inputs.append((dec, synd))
    lers = [row["ler"] for row in rows]
    if lers != sorted(lers):
        raise AssertionError(f"LER not monotone: {lers}")
    return rows


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", type=str, default=None, choices=sorted(CASES),
                    help="the --iters record of this code only")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--shots", type=int, default=None,
                    help="shots of the --iters record (default 128)")
    ap.add_argument("--iters", type=str, default=None,
                    help="lo,hi iteration budgets: the script's throughput record (slope fit)")
    ap.add_argument("--ler", action="store_true",
                    help="run the LER chain instead of throughput")
    ap.add_argument("--ler-shots", type=int, default=2048)
    ap.add_argument("--out", type=str, default=None, help="append each record to this file")
    ap.add_argument("--repeats", type=int, default=5, help="distinct batches of the per-phase mode")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.iters is None and (args.only or args.shots) and not args.ler:
        ap.error("--only and --shots size the throughput record: give --iters lo,hi")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_stbsr needs a CUDA device (or --device cpu with --ler / --iters)")
    dev = resolve_device(args.device)
    if args.ler:
        ler_chain(args.ler_shots, args.rounds, dev, out=args.out)
    elif args.iters is not None:
        lo, hi = (int(x) for x in args.iters.split(","))
        for name, getH in CASES.items():
            if args.only and args.only != name:
                continue
            bench_decode(name, getH(), args.rounds, args.shots or 128, lo, hi, args.out, dev)
    elif dev.type != "cuda":
        raise SystemExit("bench_stbsr's per-phase mode needs a CUDA device")
    else:
        per_phase(args.repeats, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
