"""Where one batch of a memory-experiment pipeline spends its device time.

    python -m exp_ldpc_tpu_torch.experiments.profile_batch [--mode MODE] [--route ROUTE]
                                                          [--p P] [--shots S] [--trace PATH]

Builds the flagship pipeline (HGP-225, 4 rounds, pheno noise with 2/3·p
priors, min-sum α=0.625, 48 iterations, OSD-CS order 7) in ``--mode``
(``bposd``, default, at p = 3.48e-3; ``bposd_single_shot`` and
``bposd_hybrid`` at p = 0.002, the point their LER artifact holds) on the
card (``--route streamed``: K2 and K6 on their streamed route, the
device-memory grids, for a trace of both routes in one run),
times ``--repeats`` untraced batches, then traces one more ``run_bposd``
with :func:`..utils.observability.profiler_trace` (``torch.profiler``, CPU
and CUDA activities; the Chrome trace moved to ``--trace``) and reads it:

  * ``span_ms``: host wall time of the traced batch, synchronised;
  * ``busy_ms``: the union of kernel, memcpy and memset intervals on the
    card; ``idle_share`` = 1 - busy/span;
  * device time and count per kernel name and per ported kernel
    (``kernels``: K1, K2 and K6 by route, K3; K1's grids are
    ``bsr_bp_check_kernel``, ``bsr_bp_var_kernel`` and
    ``bsr_bp_parity_kernel``, at most three per iteration, or one
    ``bsr_bp_coop_kernel`` per decode on its cooperative route, and
    ``k1_calls`` counts its decodes in the traced batch), K3's grids (three per
    iteration: ``stbsr_check_kernel``, ``stbsr_var_kernel``,
    ``stbsr_parity_kernel``) split into the device step (the first ``3 *
    max_iter``) and the host BP+OSD redecode (the rest, those that return
    at once after its early exit included), device-to-host copies, and the
    largest gap between device events.

The last line of standard output is the summary as one JSON object.  Needs
a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict
from contextlib import ExitStack
from functools import partial
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from ..circuits.noise import depolarizing_noise
from ..codes.hgp import biregular_hgp
from ..decoders import bp_bsr, bp_cuda, spacetime_bp_cuda
from ..parallel.pipeline import StorageDecodePipeline
from ..utils.cuda_build import BUILD_DIR
from ..utils.observability import profiler_trace

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MODES = ("bposd", "bposd_single_shot", "bposd_hybrid")
_P_DEFAULT = {"bposd": 0.0034822022531844966, "bposd_single_shot": 0.002,
              "bposd_hybrid": 0.002}
# the ported kernels' grids by function name (a K2 or K6 route each; the
# streamed routes of K2 and K6 run two grids an iteration and a parity grid)
_FAMILIES = {"bsr_bp_check_kernel": "K1", "bsr_bp_var_kernel": "K1",
             "bsr_bp_parity_kernel": "K1", "bsr_bp_coop_kernel": "K1 coop",
             "bsr_int8_check_kernel": "K5", "bsr_int8_var_kernel": "K5",
             "bsr_int8_parity_kernel": "K5", "stbp_resident_kernel": "K2 resident",
             "stbsr_check_kernel": "K3",
             "stbsr_var_kernel": "K3", "stbsr_parity_kernel": "K3",
             "stbsr_check_wide_kernel": "K3", "bsr_bp_check_wide_kernel": "K1",
             "bp_resident_kernel": "K6 resident",
             **{f"{pre}_streamed_{grid}_kernel": f"{k} streamed"
                for pre, k in (("stbp", "K2"), ("bp", "K6"))
                for grid in ("check", "check_wide", "var", "parity")}}


def _function(name: str) -> str:
    """The function name of a kernel event ("void f<...>(...)" -> "f")."""
    head = name.split("(")[0].split("<")[0].strip()
    return head.split()[-1] if head else head


def _busy_and_gap(intervals):
    """Union length and largest gap of (start, end) intervals, in µs."""
    busy, gap, cur_s, cur_e = 0.0, 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gap = max(gap, s - cur_e)
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gap


def summarize(trace: dict, max_iter: int) -> dict:
    """Device-time summary of a Chrome trace written by ``torch.profiler``."""
    events = sorted((e for e in trace["traceEvents"] if e.get("cat") in _DEVICE_CATS),
                    key=lambda e: e["ts"])
    busy, gap = _busy_and_gap([(e["ts"], e["ts"] + e["dur"]) for e in events])
    per_name = defaultdict(lambda: [0, 0.0])
    for e in events:
        rec = per_name[e["name"][:90]]
        rec[0] += 1
        rec[1] += e["dur"] / 1e3
    families = defaultdict(lambda: [0, 0.0])
    for e in events:
        fam = _FAMILIES.get(_function(e["name"])) if e.get("cat") == "kernel" else None
        if fam:
            families[fam][0] += 1
            families[fam][1] += e["dur"] / 1e3
    k3 = [e["dur"] / 1e3 for e in events if "stbsr_" in e["name"]]
    step = 3 * max_iter   # grids of the device step: three phases per iteration
    dtoh = [e["dur"] / 1e3 for e in events if "DtoH" in e["name"]]
    top = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:12]
    return {
        "busy_ms": busy / 1e3, "largest_gap_ms": gap / 1e3, "device_events": len(events),
        "k3_launches": len(k3), "k3_device_step_ms": float(sum(k3[:step])),
        "k3_redecode_ms": float(sum(k3[step:])),
        "dtoh_copies": len(dtoh), "dtoh_ms": float(sum(dtoh)),
        "kernels": {k: {"grids": n, "ms": ms} for k, (n, ms) in sorted(families.items())},
        "top": [[name, n, round(ms, 3)] for name, (n, ms) in top],
    }


def parse_args(argv=None) -> argparse.Namespace:
    """The command line, with ``--p`` defaulting to the mode's point."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=MODES, default="bposd")
    ap.add_argument("--p", type=float, default=None,
                    help="physical error rate (default: 3.48e-3 for bposd, 0.002 for the modes)")
    ap.add_argument("--route", choices=("auto", "streamed"), default="auto",
                    help="K2's and K6's route (streamed: the device-memory grids)")
    ap.add_argument("--shots", type=int, default=16384)
    ap.add_argument("--repeats", type=int, default=5, help="untraced batches timed first")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", type=Path, default=None,
                    help="where to write the Chrome trace (default: "
                    "build/exp_ldpc_tpu_torch/profile_batch_<mode>_<route>.json)")
    args = ap.parse_args(argv)
    if args.p is None:
        args.p = _P_DEFAULT[args.mode]
    if args.trace is None:
        args.trace = BUILD_DIR / f"profile_batch_{args.mode}_{args.route}.json"
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_batch needs a CUDA device")
    dev = torch.device("cuda")
    p, max_iter = args.p, 48
    code = biregular_hgp(12, 3, 4, seed=0, compute_logicals=True)
    pipe = StorageDecodePipeline(
        code=code, rounds=4, noise_model=depolarizing_noise(p, p),
        data_prior=2 / 3 * p, meas_prior=2 / 3 * p, shots_per_device=args.shots,
        max_iter=max_iter, bp_method="ms", ms_scaling_factor=0.625,
        osd_fallback_cap=args.shots, osd_options=dict(osd_method="osd_cs", osd_order=7),
        mode=args.mode, device=dev)
    gens = []
    for i in range(args.repeats + 2):
        g = torch.Generator(device=dev)
        g.manual_seed(args.seed * 1000 + i)
        gens.append(g)
    kernels = (spacetime_bp_cuda, bp_cuda)
    with ExitStack() as stack:
        if args.route == "streamed":
            for mod in kernels:
                stack.enter_context(mock.patch.object(
                    mod, "launch_plan", partial(mod.launch_plan, route="streamed")))
        pipe.run_bposd(gens[0])  # warm-up: kernel build and first launches
        walls = []
        for g in gens[1:-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.run_bposd(g)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        for mod in kernels + (bp_bsr,):
            mod.KERNEL.reset_counts()
        with profiler_trace(str(args.trace.parent)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            failures, shots, osd = pipe.run_bposd(gens[-1])
            torch.cuda.synchronize()
            span = time.perf_counter() - t0
    (args.trace.parent / "trace.json").replace(args.trace)
    trace = json.loads(args.trace.read_text())
    out = {"mode": args.mode, "route": args.route,
           "routes": {"K2": dict(spacetime_bp_cuda.KERNEL.routes),
                      "K6": dict(bp_cuda.KERNEL.routes)},
           "k1_calls": dict(bp_bsr.KERNEL.routes),
           "p": p, "shots": shots, "failures": failures, "osd_decoded": osd,
           "untraced_wall_ms_median": float(np.median(walls)) * 1e3,
           "span_ms": span * 1e3, **summarize(trace, max_iter)}
    out["idle_share"] = 1.0 - out["busy_ms"] / out["span_ms"]
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
