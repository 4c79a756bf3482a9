"""Time breakdown of K1 on the n = 4,862 cyclic lifted product, one card.

    python -m exp_ldpc_tpu_torch.experiments.bench_bsr_ablation [--device cuda|cpu]

Counterpart of ``scripts/bench_bsr_ablation.py``.  Runs the fixed-iteration
bf16 decode (K1, ``decoders/bp_bsr.py::bsr_bp_decode``) in full, without
the check update (``ablate="no_check"``: what is left is the variable side,
the routing) and without the routing (``"no_route"``: the check update and
a copy of the messages), so that full - no_check and full - no_route split
K1's time between the check phase and the variable phase.

The script's configuration: the cyclic lifted product (q = 22, m = 1,
w = 14, r = 5, seed 42; Z checks and qubits in QC order), 1,024 shots, 32
min-sum iterations at alpha 0.625, fixed iterations, shot block 128,
p = 1e-3; and its methodology: a run decodes R distinct syndrome batches
one after another, each time the best of 3 distinct sets, and the time per
decode is the slope between R = 4 and R = 16.  The batches are drawn on the
device (``torch.Generator``, seed 0) before any timing.  Each row has the
script's keys (``tiles`` is the port's ``BSRLayout.num_tiles``, the JAX
schedule's tile count; ``compile_s`` the first run's seconds, the kernel's
build included), the decode's bound (``utils/bounds.py``: its inputs and
outputs once, the operations the ablation leaves) and its share, the card's
name and power limit.  ``--device cpu`` runs the plain version (the tests
call :func:`rows` with a few shots and iterations: not a rate of a card).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from ..decoders.bp import priors_to_llr
from ..decoders import bp_bsr
from ..decoders.bp_bsr import BSRLayout, bsr_bp_decode
from ..decoders.tanner import TannerELL
from ..utils.bounds import ABLATE_OPS, bound, flat_io
from ..utils.device import resolve_device
from .bench_bsr_shard import build_code
from .bench_mxu_dtypes import card_label, timed_s

__all__ = ["SHOTS", "ITERS", "P", "ALPHA", "SHOT_BLOCK", "REPS", "ABLATIONS", "rows", "main"]

SHOTS, ITERS, P, ALPHA, SHOT_BLOCK = 1024, 32, 1e-3, 0.625, 128
REPS = (4, 16)
ABLATIONS = tuple(bp_bsr.ABLATIONS)   # "", "no_check", "no_route": the script's rows


def rows(dev: torch.device, shots: int = SHOTS, iters: int = ITERS, reps=REPS) -> list:
    """The script's rows full, no_check, no_route, each printed as a JSON
    line; the CPU tests pass a few shots and iterations."""
    card = card_label(dev)
    reps_lo, reps_hi = reps
    H = build_code("cyclic4862")
    layout = BSRLayout.from_tanner(TannerELL.from_check_matrix(H), dev)
    prior = torch.as_tensor(priors_to_llr(np.full(H.shape[1], P))).to(dev)
    Hs = torch.sparse_csr_tensor(torch.as_tensor(H.indptr, dtype=torch.int64),
                                 torch.as_tensor(H.indices, dtype=torch.int64),
                                 torch.ones(H.nnz, dtype=torch.float32), H.shape).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def synds(R: int):
        """R distinct (C, shots) uint8 syndrome batches of i.i.d. errors at p."""
        err = torch.rand((H.shape[1], R * shots), generator=gen, device=dev) < P
        st = torch.remainder(Hs @ err.to(torch.float32), 2.0).to(torch.uint8)
        return list(st.reshape(H.shape[0], R, shots).permute(1, 0, 2).contiguous())

    los = [synds(reps_lo) for _ in range(3)]
    his = [synds(reps_hi) for _ in range(3)]

    def run(ablate: str, batches):
        tot = torch.zeros((), dtype=torch.int64, device=dev)
        for s in batches:
            hard = bsr_bp_decode(layout, prior, s, "ms", iters, ALPHA, False, SHOT_BLOCK,
                                 ablate)[0]
            tot += hard.sum()
        return tot

    def timed(ablate: str, sets) -> float:
        return min(timed_s(lambda: run(ablate, x), dev) for x in sets)

    tables = layout.tables
    out = []
    for ablate in ABLATIONS:
        t0 = time.perf_counter()
        run(ablate, los[0])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        compile_s = time.perf_counter() - t0
        run(ablate, his[0])
        per = (timed(ablate, his) - timed(ablate, los)) / (reps_hi - reps_lo)
        b = bound(flat_io(tables, shots) + 4 * tables.num_checks,
                  ABLATE_OPS[ablate] * H.nnz * shots * iters)
        row = {
            "ablate": ablate or "full", "tiles": layout.num_tiles,
            "us_per_iter_128shots": per / iters / (shots / 128) * 1e6,
            "iter_shots_per_s": iters * shots / per,
            "compile_s": compile_s,
            "ms_per_decode": per * 1e3,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "bound_share": b["bound_ms"] / (per * 1e3),
            "shots": shots, "iters": iters, "device": dev.type, "card": card,
        }
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def main(argv: Optional[list] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain version)")
    return rows(resolve_device(ap.parse_args(argv).device))


if __name__ == "__main__":
    main()
