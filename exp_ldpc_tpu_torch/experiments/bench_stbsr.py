"""K3 (spacetime BP, ``csrc/stbsr.cu``) per decode and per phase.

    python -m exp_ldpc_tpu_torch.experiments.bench_stbsr

Counterpart of ``scripts/bench_stbsr.py`` with its two large codes (the
cyclic lifted product n = 4,862 and ``biregular_hgp(80, 3, 4, seed=7)``
n = 10,000; 8 rounds, 128 shots, 32 iterations, p = 1e-3), plus the
flagship's shapes (HGP-225, 4 rounds, 48 iterations, 16,384 shots: the
``bposd`` device step; 685 shots: its host redecode).  For each shape and
method it times ``stbsr_decode`` (CUDA events, median of ``--repeats``
distinct batches, fixed iterations) and traces one more decode with
``torch.profiler`` to split the device time over the three grids of an
iteration (checks, variables, parity).  One JSON line per case; the last
line holds all of them with the card's name and power limit.  Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from ..codes.hgp import biregular_hgp
from ..codes.lifted import lifted_product_code_cyclic
from ..convert import tanner_tables
from ..decoders.bp import priors_to_llr
from ..decoders.bp_bsr_spacetime import stbsr_decode
from ..decoders.spacetime import SpacetimeCode
from ..decoders.tanner import TannerELL
from .bench_grid_barrier import _ms, _syndromes

_PHASES = {"stbsr_check_kernel": "checks_ms", "stbsr_var_kernel": "variables_ms",
           "stbsr_parity_kernel": "parity_ms"}


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_stbsr needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    hgp225 = biregular_hgp(12, 3, 4, seed=0, compute_logicals=False).checks.z
    large = {"cyclic n=4862": lifted_product_code_cyclic(
                 q=22, m=1, w=14, r=5, seed=42, compute_logicals=False).checks.z,
             "HGP n=10000": biregular_hgp(80, 3, 4, seed=7, compute_logicals=False).checks.z}
    p_flag = 2 / 3 * 0.0034822022531844966
    cases = [("HGP-225", hgp225, 4, S, 48, p_flag, "ms", 0.625) for S in (16384, 685)]
    cases += [(name, H, 8, 128, 32, 1e-3, method, msf) for name, H in large.items()
              for method, msf in (("ms", 0.625), ("ps", 0.0))]
    rows = []
    for case in cases:
        rows.append(_case(*case, args.repeats, dev))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"card": card, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
