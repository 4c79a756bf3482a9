"""The two grid barriers for K3 and K4, timed side by side on one card.

    python -m exp_ldpc_tpu_torch.experiments.bench_grid_barrier

K3 (``csrc/stbsr.cu``) and K4 (``csrc/bsr_shard.cu``) split every phase of a
BP iteration over the whole card, and the phases need a barrier across all
blocks.  The kernels use the kernel boundary: one launch per phase.  The
other way is one cooperative launch (``csrc/grid_barrier.cu``) whose
resident blocks call ``this_grid().sync()`` between the phases and, for K3,
run all iterations of a decode.  Both run the same device functions, so the
outputs must be equal bit for bit; this script checks that and times each
(CUDA events, median of ``--repeats`` distinct batches) at the shapes
``chip_smoke.py`` times K3 and K4 at:

  * K3: HGP-225, 4 rounds, 16,384 and 685 shots x 48 iterations (the
    ``bposd`` device step and its host redecode), fixed and with the early
    exit; the n = 10,000 HGP and the cyclic n = 4,862 code, 8 rounds, 128
    shots x 32 iterations;
  * K4: one decode iteration over all shards at the capacity code
    (n = 40,000, D = 8, 128 shots) and at the cyclic n = 4,862 code
    (1,024 shots, D = 1 and 4), as the slope between 4 and 12 iterations.

Min-sum only.  Prints one JSON line per shape and, last, one with all of
them, the card's name and its power limit.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from ..codes.hgp import biregular_hgp
from ..codes.lifted import lifted_product_code_cyclic
from ..convert import tanner_tables
from ..decoders import bp_bsr_shard as k4
from ..decoders import bp_bsr_spacetime as k3
from ..decoders.bp import priors_to_llr
from ..decoders.spacetime import SpacetimeCode
from ..decoders.tanner import TannerELL
from ..utils.cuda_build import CudaKernel
from . import bench_bsr_shard, shard_capacity

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
K3_COOP = CudaKernel("grid_barrier.cu", "stbsr_run_coop",
                     [_P] * 14 + [_I] * 7 + [_F] + [_I] * 7 + [_P])
K4_COOP = CudaKernel("grid_barrier.cu", "bsr_shard_coop",
                     [_P] * 9 + [_I] * 6 + [_F] + [_I] * 4 + [_P])


def _run_coop(t, R, msg, mlo, mhi, synd, prior_d, mprior, post_d, post_m, conv, c2m, hard,
              flags, live, method, alpha, adaptive, n_iter):
    """``bp_bsr_spacetime._run`` through the cooperative launch."""
    dev = msg.device
    S = msg.shape[1]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    pa, pb, pc = k3.launch_plans(t, R, S, sms)
    assert method == "ms"
    K3_COOP.launch(
        t.chk_vars_k.data_ptr(), t.vm_k.data_ptr(), msg.data_ptr(), mlo.data_ptr(),
        mhi.data_ptr(), synd.data_ptr(), prior_d.data_ptr(), mprior.data_ptr(),
        post_d.data_ptr(), post_m.data_ptr(), conv.data_ptr(), c2m.data_ptr(), hard.data_ptr(),
        None if flags is None else flags.data_ptr(),
        t.num_checks, t.num_vars, t.max_check_degree, t.max_var_degree, R, S, live,
        float(alpha), int(adaptive), 0, n_iter, pa.vec, pb.vec, pc.vec,
        max(pa.blocks, pb.blocks, pc.blocks), torch.cuda.current_stream(dev).cuda_stream)


def stbsr_decode_coop(*args, **kw):
    """``stbsr_decode`` with the device loop in one cooperative launch."""
    kept = k3._run
    k3._run = _run_coop
    try:
        return k3.stbsr_decode(*args, **kw)
    finally:
        k3._run = kept


def bsr_shard_iter_coop(sh, posterior, messages, syndromes, alpha, method, out=None,
                        out_part=None, accumulate=False):
    """``bsr_shard_iter`` through the cooperative launch (the decoder's
    calls: ``out`` and ``out_part`` given)."""
    dev = posterior.device
    S = posterior.shape[1]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    pa, pb = k4.launch_plans(sh, S, sms, accumulate)
    assert method == "ms"
    K4_COOP.launch(
        sh.chk_vars_k.data_ptr(), sh.nslot(method).data_ptr(), sh.lvar_k.data_ptr(),
        sh.lvm_k.data_ptr(), posterior.data_ptr(), messages.data_ptr(), syndromes.data_ptr(),
        out.data_ptr(), out_part.data_ptr(), sh.c_pad_loc, sh.dc, sh.v_pad, sh.n_loc, sh.dv, S,
        float(alpha), int(accumulate), pa.vec, pb.vec, max(pa.blocks, pb.blocks),
        torch.cuda.current_stream(dev).cuda_stream)
    return out, out_part


def _ms(fn, inputs) -> float:
    times = []
    for x in inputs:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn(x)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _syndromes(H, S, p, seed, dev):
    rng = np.random.default_rng(seed)
    err = (rng.random((S, H.shape[1])) < p).astype(np.int64)
    return torch.as_tensor(((H @ err.T) % 2).astype(np.uint8)).to(dev)


def _k3_case(name, H, rounds, S, iters, p, early_stop, repeats, dev) -> dict:
    tables = tanner_tables(TannerELL.from_check_matrix(H), dev)
    Hst = SpacetimeCode(H, rounds).spacetime_check_matrix.tocsr().astype(np.int64)
    prior = torch.as_tensor(priors_to_llr(np.full(Hst.shape[1], p))).to(dev)
    synds = [_syndromes(Hst, S, p, 100 + i, dev) for i in range(repeats + 1)]
    args = (tables, rounds, prior)
    tail = ("ms", iters, 0.625, early_stop)
    a = k3.stbsr_decode(*args, synds[-1], *tail)
    b = stbsr_decode_coop(*args, synds[-1], *tail)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{name}: the cooperative decode differs from the kernels'")
    return {"kernel": "K3", "shape": name, "shots": S, "iters": iters, "early_stop": early_stop,
            "iters_run": int(a[3][0]),
            "launch_per_phase_ms": _ms(lambda s: k3.stbsr_decode(*args, s, *tail), synds[:-1]),
            "cooperative_ms": _ms(lambda s: stbsr_decode_coop(*args, s, *tail), synds[:-1])}


def _k4_case(name, H, dec, S, p, dev) -> dict:
    synd = _syndromes(H.astype(np.int64), S, p, 7, dev)
    a = dec.decode_tensors(synd, max_iter=8)
    b = dec.decode_tensors(synd, max_iter=8, iterate=bsr_shard_iter_coop)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{name}: the cooperative decode differs from the kernels'")
    slope = {}
    for key, it in (("launch_per_phase_ms", k4.bsr_shard_iter),
                    ("cooperative_ms", bsr_shard_iter_coop)):
        slope[key] = 1e3 * shard_capacity.per_iter_slope(
            lambda s, n, it=it: dec.decode_tensors(s, max_iter=n, iterate=it), H, dev, S, p,
            lo=4, hi=12, nrep=3)
    return {"kernel": "K4", "shape": name, "shots": S, "shards": dec.sharded.num_shards,
            "per": "decode iteration, all shards", **slope}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_grid_barrier needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    rows = []

    def add(rec):
        rows.append(rec)
        print(json.dumps(rec), flush=True)

    hgp225 = biregular_hgp(12, 3, 4, seed=0, compute_logicals=False).checks.z
    p = 2 / 3 * 0.0034822022531844966
    for S in (16384, 685):
        for es in (False, True):
            add(_k3_case("HGP-225 x4 rounds", hgp225, 4, S, 48, p, es, args.repeats, dev))
    add(_k3_case("HGP n=10000 x8 rounds",
                 biregular_hgp(80, 3, 4, seed=7, compute_logicals=False).checks.z, 8, 128, 32,
                 1e-3, False, args.repeats, dev))
    add(_k3_case("cyclic n=4862 x8 rounds", lifted_product_code_cyclic(
        q=22, m=1, w=14, r=5, seed=42, compute_logicals=False).checks.z, 8, 128, 32, 1e-3,
        False, args.repeats, dev))
    H, dec, rec = shard_capacity.build(device=dev)
    add(_k4_case("capacity n=40000", H, dec, 128, 5e-4, dev))
    H = bench_bsr_shard.build_code("cyclic4862")
    for D in (1, 4):
        dec = k4.ShardedBSRDecoder.from_check_matrix(H, D, error_rate=1e-3, max_iter=32,
                                                     bp_method="ms", device=dev)
        add(_k4_case("cyclic n=4862", H, dec, 1024, 1e-3, dev))
    print(json.dumps({"card": card, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
