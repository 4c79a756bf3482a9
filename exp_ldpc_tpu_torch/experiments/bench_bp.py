"""Benchmark: flat BP decode throughput on the (3,4) HGP-225 code, one NVIDIA GPU.

    python -m exp_ldpc_tpu_torch.experiments.bench_bp

The port's counterpart of the repository's ``bench.py``, which stays the
JAX package's benchmark.  Same configuration: HGP-225 Z checks, batch
1,024, 32 fixed min-sum iterations, α = 0.625, p = 1e-3 syndromes.  Same
method:

  * each repeat decodes a DISTINCT syndrome batch, so no layer can serve a
    repeat from an earlier identical call;
  * the repeats run back to back on the card and end in one
    ``torch.cuda.synchronize()``; two repeat counts (8 and 64) are timed,
    best of three each, and the per-batch time is the slope between them,
    which removes the fixed cost of one dispatch and the final transfer.

The decode is the one ``make_bp_decoder`` (``early_stop=False``) selects
for this code on the card: kernel K6 (``csrc/bpflat.cu``, f32 messages
resident in shared memory, 71 shots of HGP-225 to a block), where
``bench.py`` times the JAX package's choice on a TPU, the bf16 BSR kernel
(K1's contract; ``artifacts/select_h100.jsonl``, flat ``hgp_225``, fixed:
K6 0.247 ms against K1 0.469 ms at 1,024 shots x 48, NVIDIA H100 80GB
HBM3, 700 W).  Where ``bench.py`` reports ``xla_matmul_rate`` (the XLA
matmul formulation that the BSR kernel replaced on the TPU), this reports
``plain_rate``: the plain PyTorch ``bp_core`` (f32, gather form) on the
same card, the plain version the port holds its flat kernels against; the
port has no XLA formulation.

Prints ONE JSON line with ``bench.py``'s keys (``plain_rate`` for
``xla_matmul_rate``) plus the card's name.  Needs a CUDA device.
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch

from ..codes.hgp import biregular_hgp
from ..decoders import bp_cuda
from ..decoders.bp import bp_core, priors_to_llr
from ..decoders.select import make_bp_decoder

SHOTS, ITERS, P, ALPHA = 1024, 32, 1e-3, 0.625
REPS_LO, REPS_HI = 8, 64


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bench_bp measures a CUDA device; none is present")
    dev = torch.device("cuda")
    Hz = biregular_hgp(12, 3, 4, seed=0, compute_logicals=False).checks.z
    dec = make_bp_decoder(Hz, error_rate=P, max_iter=ITERS, bp_method="ms",
                          ms_scaling_factor=ALPHA, early_stop=False, device=dev)
    tables = dec.tables
    prior = torch.as_tensor(priors_to_llr(np.full(Hz.shape[1], P))).to(dev)
    Hz_dense = Hz.T.toarray().astype(np.uint8)
    rng = np.random.default_rng(0)

    def make_syndromes(n_batches):
        errors = (rng.random((n_batches, SHOTS, Hz.shape[1])) < P).astype(np.uint8)
        stacked = (errors @ Hz_dense) % 2                                  # (R, S, C)
        return torch.as_tensor(stacked.astype(np.uint8).transpose(0, 2, 1).copy()).to(dev)

    def run_kernel(synds):
        total = torch.zeros((), dtype=torch.int64, device=dev)
        for synd in synds:
            total += dec.decode_tensors(synd)[0].sum()
        return total

    def run_plain(synds):
        total = torch.zeros((), dtype=torch.int64, device=dev)
        for synd in synds:
            total += bp_core(tables, prior, synd, "ms", ITERS, ALPHA, False)[0].sum()
        return total

    los = [make_syndromes(REPS_LO) for _ in range(3)]
    his = [make_syndromes(REPS_HI) for _ in range(3)]

    def rate_of(run_many):
        run_many(los[0]).item()  # warm-up (and the kernel's build)
        run_many(his[0]).item()

        def timed(xs):
            best = np.inf
            for x in xs:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run_many(x).item()  # .item() synchronises
                best = min(best, time.perf_counter() - t0)
            return best

        per_batch = (timed(his) - timed(los)) / (REPS_HI - REPS_LO)
        return ITERS * SHOTS / per_batch

    plain = rate_of(run_plain)
    launched = bp_cuda.KERNEL.launches
    value = rate_of(run_kernel)
    if bp_cuda.KERNEL.launches == launched:
        raise SystemExit(f"the selected {type(dec).__name__} launched no K6 decode")
    plan = bp_cuda.launch_plan(tables, SHOTS, dev)
    print(json.dumps({
        "metric": "bp_iter_shots_per_s_per_chip",
        "value": value,
        "unit": "iter*shots/s",
        "vs_baseline": value / 1e7,
        "formulation": f"bpflat-cuda[{plan.label}, {plan.group} shots a block]",
        "plain_rate": plain,
        "device": torch.cuda.get_device_name(0),
    }), flush=True)


if __name__ == "__main__":
    main()
