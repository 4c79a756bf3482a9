"""BP decode throughput across code families and formulations on one device.

Counterpart of ``scripts/bench_large_codes.py``, with its cases: the gross
code [[144,12,12]], an HGP ladder (n = 225 / 400 / 625 / 1600 / 2025), the
QC lifted product [[1054,140]], the cyclic lifted product n = 4,862 (in QC
order for the kernel rows) and an n = 10,000 HGP, each on the formulations
that apply.  A row's tag is ``name/formulation``:

  * ``base``      :func:`..decoders.bp.bp_core` (plain PyTorch, gather form);
  * ``bsr``       kernel K1, :func:`..decoders.bp_bsr.bsr_bp_decode` (bf16);
  * ``bsr-int8``  kernel K5, :func:`..decoders.bp_bsr.bsr_bp_decode_int8`;
  * ``qc``        :func:`..decoders.qc_bp.qc_bp_core` (cyclic rolls).

Method as in the JAX script: fixed-iteration min-sum (alpha 0.625, i.e.
``alpha_num`` 160), a DISTINCT syndrome batch for every timed decode, and
the time per decode as a slope over two repeat counts (``--reps-lo`` /
``--reps-hi`` decodes, best of 3, device-synchronised), so fixed per-call
costs cancel.  Batches are drawn on the device from a fixed seed.  One JSON
line per row, with the JAX script's keys (``compile_s`` is the first
decode's wall time, kernel build included) plus ``device``; ``--write PATH``
merges the rows into a JSON-lines file.  With ``--device cpu`` the kernel
rows run their plain versions.

    python -m exp_ldpc_tpu_torch.experiments.bench_large_codes --only qclp
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from functools import lru_cache

import numpy as np
import torch
from scipy import sparse

from ..codes.bivariate_bicycle import gross_code
from ..codes.hgp import biregular_hgp
from ..codes.lifted import lifted_product_code_cyclic
from ..codes.qc_lifted import qc_lifted_product_code
from ..convert import tanner_tables
from ..decoders.bp import bp_core, priors_to_llr
from ..decoders.bp_bsr import BSRLayout, bsr_bp_decode, bsr_bp_decode_int8
from ..decoders.bp_int8 import quantize_priors
from ..decoders.qc_bp import QCStructure, qc_bp_core
from ..decoders.select import _QC_MAX_MONOMIALS
from ..decoders.tanner import TannerELL
from ..utils.device import resolve_device
from .bench_bsr_shard import slope_time
from .shard_capacity import _sync, device_name

__all__ = ["ALPHA", "ALPHA_NUM", "cases", "case_tag", "syndrome_source", "measure",
           "bench_code", "main"]

ALPHA, ALPHA_NUM = 0.625, 160


def syndrome_source(H, p: float, shots: int, dev: torch.device):
    """A function that draws one (C, shots) uint8 syndrome batch of i.i.d.
    errors at rate ``p`` on ``dev``; every call gives a new batch."""
    H = sparse.csr_matrix(H).astype(np.int64)
    Hs = torch.sparse_csr_tensor(
        torch.as_tensor(H.indptr, dtype=torch.int64), torch.as_tensor(H.indices, dtype=torch.int64),
        torch.ones(H.nnz, dtype=torch.float32), H.shape).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def draw() -> torch.Tensor:
        err = (torch.rand((H.shape[1], shots), generator=gen, device=dev) < p).to(torch.float32)
        return torch.remainder(Hs @ err, 2.0).to(torch.uint8)

    return draw


def measure(decode, draw, reps_lo: int, reps_hi: int, dev: torch.device):
    """(seconds per decode by :func:`.bench_bsr_shard.slope_time`, its
    kind, the converged share of the first ``reps_lo`` batches, the first
    decode's wall time)."""
    _sync(dev)
    t0 = time.perf_counter()
    conv = decode(draw())[2]
    _sync(dev)
    first_s = time.perf_counter() - t0
    for _ in range(reps_lo - 1):
        conv = torch.cat([conv, decode(draw())[2]])
    per, kind = slope_time(decode, draw, reps_lo, reps_hi, dev)
    return per, kind, float(conv.float().mean()), first_s


def bench_code(name, H, *, shots, iters, p, reps_lo, reps_hi, qc_dims=None, qc_perms=None,
               bsr=False, bsr_int8=False, shot_block=128, device="cuda") -> dict:
    """Time one row; returns its record."""
    dev = resolve_device(device)
    H = sparse.csr_matrix(H)
    if qc_perms is not None:
        # throughput does not depend on the order (same Tanner graph); bring
        # the matrix into block-circulant order up front, as the decoders do
        check_perm, var_perm = qc_perms
        H = H[check_perm][:, var_perm] if check_perm is not None else H[:, var_perm]
    tanner = TannerELL.from_check_matrix(H)
    prior_llr = priors_to_llr(np.full(tanner.num_vars, p))
    prior = torch.as_tensor(prior_llr).to(dev)
    if bsr or bsr_int8:
        layout = BSRLayout.from_tanner(tanner, dev)
        if bsr_int8:
            formulation = f"bsr-int8[{layout.num_tiles} tiles]"
            prior_q = torch.as_tensor(quantize_priors(prior_llr)[0]).to(dev)

            def decode(synd):
                return bsr_bp_decode_int8(layout, prior_q, synd, iters, ALPHA_NUM, False,
                                          shot_block)
        else:
            formulation = f"bsr[{layout.num_tiles} tiles]"

            def decode(synd):
                return bsr_bp_decode(layout, prior, synd, "ms", iters, ALPHA, False, shot_block)
    elif qc_dims is not None:
        struct = QCStructure.from_check_matrix(H, qc_dims)
        formulation = f"qc-roll{tuple(qc_dims)}"

        def decode(synd):
            return qc_bp_core(struct, prior, synd, "ms", iters, ALPHA, False)
    else:
        tables = tanner_tables(tanner, dev)
        formulation = "gather"

        def decode(synd):
            return bp_core(tables, prior, synd, "ms", iters, ALPHA, False)

    per, kind, conv_frac, first_s = measure(decode, syndrome_source(H, p, shots, dev), reps_lo,
                                      reps_hi, dev)
    return {
        "code": name,
        "n": tanner.num_vars,
        "checks": tanner.num_checks,
        "formulation": formulation,
        "iters": iters,
        "shots": shots,
        "p": p,
        "bp_iter_shots_per_s": iters * shots / per,
        "time_kind": kind,
        "bp_converged_frac": conv_frac,
        "compile_s": first_s,
        "shot_block": shot_block if (bsr or bsr_int8) else None,
        "device": device_name(dev),
    }


@lru_cache(maxsize=None)
def _gross_H():
    return gross_code(compute_logicals=False).checks.z


@lru_cache(maxsize=None)
def _qclp_H():
    shifts = [[1, 2, 4, 8, 16], [5, 10, 20, 9, 18], [25, 19, 7, 14, 28]]
    return qc_lifted_product_code(shifts, 31, compute_logicals=False).checks.z


@lru_cache(maxsize=None)
def _cyclic():
    return lifted_product_code_cyclic(q=22, m=1, w=14, r=5, seed=42, compute_logicals=False)


def _cyclic_H():
    return _cyclic().checks.z


def _cyc_perms():
    meta = _cyclic().qc_meta
    return (meta.z_check_perm, meta.qubit_perm)


@lru_cache(maxsize=None)
def _hgp_H(nv, seed):
    return biregular_hgp(nv, 3, 4, seed=seed, compute_logicals=False).checks.z


def _none():
    return None


def cases():
    """(name, H(), qc_dims, qc_perms(), bsr, bsr_int8) per row; the
    constructors are lazy and cached, so a filtered run builds only its
    own codes."""
    return [
        ("gross_144_12_12", _gross_H, None, _none, False, False),
        ("gross_144_12_12", _gross_H, None, _none, True, False),
        ("gross_144_12_12", _gross_H, (12, 6), _none, False, False),
    ] + [
        (f"hgp_{nv * nv + (nv * 3 // 4) ** 2}", (lambda nv=nv: _hgp_H(nv, 42)), None, _none, bsr,
         False)
        for nv in (12, 16, 20, 32, 36) for bsr in (False, True)
    ] + [
        ("qclp_1054_140", _qclp_H, None, _none, False, False),
        ("qclp_1054_140", _qclp_H, (31,), _none, False, False),
        ("qclp_1054_140", _qclp_H, None, _none, True, False),
        ("qclp_1054_140", _qclp_H, None, _none, False, True),
        ("cyclic_lp_4862", _cyclic_H, None, _none, False, False),
        # the 1332-monomial abelian LP is beyond the roll decoder's range;
        # its kernel rows run in QC order
        ("cyclic_lp_4862", _cyclic_H, None, _cyc_perms, True, False),
        ("cyclic_lp_4862", _cyclic_H, None, _cyc_perms, False, True),
        # (3,4)-HGP with nv = 80: n = 80^2 + 60^2 = 10000, 4800 Z checks
        ("hgp_10000", (lambda: _hgp_H(80, 7)), None, _none, True, False),
    ]


def case_tag(name, qc_dims, bsr, bsr_int8) -> str:
    return f"{name}/" + ("bsr-int8" if bsr_int8 else "bsr" if bsr
                         else "qc" if qc_dims is not None else "base")


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--write", default=None, metavar="PATH",
                    help="merge the rows into this JSON-lines file")
    ap.add_argument("--shots", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--p", type=float, default=1e-3)
    ap.add_argument("--only", default=None,
                    help="substring filter on 'name/formulation' (e.g. 'bsr', 'cyclic', "
                         "'qclp_1054_140/bsr-int8')")
    ap.add_argument("--shot_block", type=int, default=128,
                    help="shot block of the kernel rows (the unit of their early exit)")
    ap.add_argument("--reps-lo", type=int, default=4)
    ap.add_argument("--reps-hi", type=int, default=16)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    out = []
    for name, make_H, qc_dims, make_perms, bsr, bsr_int8 in cases():
        if args.only and args.only not in case_tag(name, qc_dims, bsr, bsr_int8):
            continue
        H = make_H()
        if qc_dims is not None and H.nnz // int(np.prod(qc_dims)) > _QC_MAX_MONOMIALS:
            continue
        rec = bench_code(name, H, shots=args.shots, iters=args.iters, p=args.p,
                         reps_lo=args.reps_lo, reps_hi=args.reps_hi, qc_dims=qc_dims,
                         qc_perms=make_perms(), bsr=bsr, bsr_int8=bsr_int8,
                         shot_block=args.shot_block, device=args.device)
        print(json.dumps(rec), flush=True)
        out.append(rec)

    if args.write:
        # merge by (code, formulation prefix): a filtered run refreshes its
        # own rows and keeps the rest of the file
        try:
            with open(args.write) as f:
                old = [json.loads(ln) for ln in f if ln.strip()]
        except FileNotFoundError:
            old = []

        def key(r):
            return (r["code"], r["formulation"].split("[")[0])

        new_keys = {key(r) for r in out}
        with open(args.write, "w") as f:
            for rec in [r for r in old if key(r) not in new_keys] + out:
                f.write(json.dumps(rec) + "\n")
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
