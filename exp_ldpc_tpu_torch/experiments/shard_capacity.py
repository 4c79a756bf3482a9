"""Capacity demonstration: check-partition BP (kernel K4) on a 40,000-qubit code.

Counterpart of ``scripts/demo_capacity_shard.py``, with its code, seeds and
defaults: the (3,4)-HGP ``biregular_hgp(160, 3, 4, seed=11)`` (n = 40,000,
19,200 Z checks), the JAX package's shard count (``auto_num_shards``: 8),
128 shots at p = 5e-4, min-sum with adaptive scaling, 32 iterations.  The
D shards run in order on one device (emulation: the kernels a D-device mesh
would run, with the all-reduce replaced by an in-order sum).  It checks
that every converged shot satisfies its syndrome and that 32 weight-1
errors decode exactly, times one decode iteration as the slope between 4
and 64 iterations (distinct batches, best of 3, CUDA-synchronised), and
prints one JSON line, with the bytes each rank would all-reduce per
iteration on a D-device mesh.

    python -m exp_ldpc_tpu_torch.experiments.shard_capacity [--device cpu --nv 20]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
from scipy import sparse

from ..codes.hgp import biregular_hgp
from ..decoders.bp import priors_to_llr
from ..decoders.bp_bsr_shard import (ShardedBSR, ShardedBSRDecoder, allreduce_bytes,
                                     auto_num_shards)
from ..utils.device import resolve_device

__all__ = ["build", "run", "per_iter_slope", "device_name", "main"]


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build(nv: int = 160, shards: int = 0, p: float = 5e-4, iters: int = 32,
          device="cuda"):
    """(H, decoder, record of the build) for the demo's code."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    H = sparse.csr_matrix(biregular_hgp(nv, 3, 4, seed=11, compute_logicals=False)
                          .checks.z)
    build_code_s = time.perf_counter() - t0
    D = shards or auto_num_shards(H)
    t0 = time.perf_counter()
    sb = ShardedBSR.from_check_matrix(H, D)
    dec = ShardedBSRDecoder(sb, priors_to_llr(np.full(H.shape[1], p)), method="ms",
                            max_iter=iters, device=dev)
    rec = {"n": H.shape[1], "checks": H.shape[0], "edges": int(H.nnz), "shards": D,
           "build_code_s": build_code_s, "build_sched_s": time.perf_counter() - t0}
    return H, dec, rec


def _syndromes(H, err: np.ndarray) -> np.ndarray:
    return np.asarray((H @ err.T % 2).astype(np.uint8).T)


def run(H, dec: ShardedBSRDecoder, shots: int = 128, p: float = 5e-4) -> dict:
    """The demo's decode and checks (raises if a check fails)."""
    rng = np.random.default_rng(3)
    V = H.shape[1]
    err = (rng.random((shots, V)) < p).astype(np.uint8)
    synd = _syndromes(H, err)
    dev = dec.device
    _sync(dev)
    t0 = time.perf_counter()
    hard, _post, conv = dec.decode_batch(synd)
    first_s = time.perf_counter() - t0
    ok = (_syndromes(H, hard) == synd).all(axis=1)
    if not ok[conv].all():
        raise AssertionError("a converged shot violates its syndrome")
    sites = rng.choice(V, size=32, replace=False)
    e1 = np.zeros((32, V), np.uint8)
    e1[np.arange(32), sites] = 1
    h1, _p1, c1 = dec.decode_batch(_syndromes(H, e1))
    if not (c1.all() and (h1 == e1).all()):
        raise AssertionError("weight-1 errors must decode exactly")
    return {"shots": shots, "iters": dec.max_iter, "converged_frac": float(conv.mean()),
            "exact_recovery": int((hard == err).all(axis=1).sum()), "weight1_exact": 32,
            "first_decode_s": first_s,
            "allreduce_bytes_per_iter": allreduce_bytes(dec.sharded.num_shards,
                                                        dec.sharded.v_pad, shots)}


def per_iter_slope(decode, H, dev: torch.device, shots: int = 128, p: float = 5e-4,
                   lo: int = 4, hi: int = 64, nrep: int = 3) -> float:
    """Seconds per iteration of ``decode(syndromes, n_iter)`` (syndromes
    (C, shots) uint8 on ``dev`` of i.i.d. errors at rate ``p``): the slope
    between ``lo`` and ``hi`` iterations, best of ``nrep`` distinct batches
    each."""
    rng = np.random.default_rng(5)

    def batch():
        e = (rng.random((shots, H.shape[1])) < p).astype(np.uint8)
        return torch.as_tensor(np.ascontiguousarray(_syndromes(H, e).T)).to(dev)

    def best(n_iter, xs):
        t = np.inf
        for x in xs:
            _sync(dev)
            t0 = time.perf_counter()
            decode(x, n_iter)
            _sync(dev)
            t = min(t, time.perf_counter() - t0)
        return t

    los, his = [batch() for _ in range(nrep)], [batch() for _ in range(nrep)]
    best(lo, los[:1])
    best(hi, his[:1])
    return (best(hi, his) - best(lo, los)) / (hi - lo)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nv", type=int, default=160)
    ap.add_argument("--shards", type=int, default=0, help="0 = auto_num_shards")
    ap.add_argument("--shots", type=int, default=128)
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--p", type=float, default=5e-4)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    H, dec, rec = build(args.nv, args.shards, args.p, args.iters, args.device)
    rec.update(run(H, dec, args.shots, args.p))
    per_iter = per_iter_slope(lambda s, n: dec.decode_tensors(s, max_iter=n), H, dec.device,
                              args.shots, args.p)
    rec.update(device=device_name(dec.device), per_iter_s_all_shards=per_iter,
               iter_shots_per_s_equiv=args.shots / per_iter if per_iter > 0 else None)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
