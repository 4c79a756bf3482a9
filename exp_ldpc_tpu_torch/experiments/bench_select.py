"""What each decoder-selection point can choose, timed on one NVIDIA GPU.

    python -m exp_ldpc_tpu_torch.experiments.bench_select [--only SUBSTR] [--repeats N]
                                                         [--candidates NAMES] [--tag TEXT]
                                                         [--write PATH]

For each call that :mod:`..decoders.select` answers, every decoder the JAX
package can return for it (on a TPU or on a CPU) is timed on the same
inputs: CUDA events around one ``decode_tensors`` call, the median of
``--repeats`` distinct syndrome batches after a warm-up batch (kernel
builds excluded).  A candidate is a decoder class and an exit request:

  * flat BP (:func:`..decoders.select.make_bp_decoder`): kernel K1
    (``BSRBPDecoder``: bf16 messages, exit per shot block, or fixed);
    ``BPDecoder`` with per-shot freezing (plain ``bp_core``) or fixed (kernel
    K6); ``QCBPDecoder`` (plain roll decoder) where the code has ``qc_dims``;
  * spacetime BP (:func:`..decoders.select.make_spacetime_bp_decoder` and
    the pipeline's ``bposd`` stage): kernel K3 (``SpacetimeBSRDecoder``:
    bf16, global exit, or fixed); ``SpacetimeBPDecoder`` fixed (kernel K2 on
    the route its launch plan picks) or with per-shot freezing (plain
    ``stbp_core``).

The codes and shot counts are those of the selection's callers: the family
benchmark's nine codes, HGP n = 15,625 and 40,000, HGP-225's single-shot
matrix (H|I), HGP-225's 1- and 4-round circuit-noise detector models and
five HGP codes of 12-20 slot checks (:data:`WIDTH_PROBES`) (flat: 685, 1,024, 2,048 and 16,384 shots, 48 min-sum iterations); HGP-225
over 4 rounds, the gross code over 12, the cyclic lifted product n = 4,862
over 4 and 8, HGP n = 10,000 over 8 and n = 15,625 over 4 (spacetime, at
their callers' shots and iterations).  Syndromes are drawn on the card from
i.i.d. faults at the column priors (a detector model's own priors).  A
plain candidate whose temporaries would pass :data:`PLAIN_BUDGET` bytes is
not run (its row says so).

One JSON row per (code, shots, candidate): ms per decode, the contract
(message dtype; exit per shot, per block, global or none), the launched
kernel's route, the converged share, the mean iterations, the card's name,
power limit and opt-in shared memory per block.  ``--candidates K2,K6``
times only the named candidates; ``--tag TEXT`` adds ``"tag": TEXT`` to
every row (which run of a rule's inputs it is).  ``--write PATH`` appends
the rows.  The 4-round detector model takes ~150 s of host Python; it is
built in a spawned process while the other rows are timed.  Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
from scipy import sparse

from ..codes.bivariate_bicycle import gross_code
from ..codes.hgp import biregular_hgp
from ..decoders import bp_bsr, bp_bsr_spacetime, bp_cuda, select, spacetime_bp_cuda
from ..decoders.bp import BPDecoder
from ..decoders.bp_bsr import BSRBPDecoder
from ..decoders.drivers import spacetime_prior
from ..decoders.bp_bsr_spacetime import SpacetimeBSRDecoder
from ..decoders.qc_bp import QCBPDecoder
from ..decoders.spacetime import DetectorSpacetimeCode, SpacetimeCode, SpacetimeCodeSingleShot
from ..decoders.spacetime_bp import SpacetimeBPDecoder
from ..decoders.tanner import TannerELL
from ..utils.cuda_build import device_limits
from . import bench_large_codes as fam

__all__ = ["Candidate", "Case", "FLAT", "SPACETIME", "flat_case", "spacetime_case",
           "flat_cases", "dem4_case", "spacetime_cases", "auto_candidate", "decoder",
           "draw_syndromes", "measure", "card", "main"]

ALPHA = 0.625
FLAT_SHOTS = (685, 1024, 2048, 16384)
FLAT_ITERS = 48
DEM_P = 7.917e-4          # validate_dem's gated point (chip_smoke.py phase 30)
P_FLAGSHIP = 0.0034822022531844966   # the bposd flagship's p (validate_ler's grid point)
PLAIN_BUDGET = 40e9       # bytes of plain-core temporaries a row may take on an 80 GB card
KERNELS = {"K1": bp_bsr.KERNEL, "K2": spacetime_bp_cuda.KERNEL, "K3": bp_bsr_spacetime.KERNEL,
           "K6": bp_cuda.KERNEL}


class Candidate(NamedTuple):
    """A decoder the JAX package can return for a selection point: its name,
    the exit it is asked for ("early_stop" or "fixed"), the contract it then
    has (message dtype; exit "shot", "block", "global" or "none") and the
    port's kernel ("plain" for none)."""
    name: str
    request: str
    msg_dtype: str
    exit: str
    kernel: str


FLAT = (Candidate("K1", "early_stop", "bfloat16", "block", "K1"),
        Candidate("K1", "fixed", "bfloat16", "none", "K1"),
        Candidate("bp_core", "early_stop", "float32", "shot", "plain"),
        Candidate("K6", "fixed", "float32", "none", "K6"),
        Candidate("qc", "early_stop", "float32", "shot", "plain"),
        Candidate("qc", "fixed", "float32", "none", "plain"))
SPACETIME = (Candidate("K3", "early_stop", "bfloat16", "global", "K3"),
             Candidate("K3", "fixed", "bfloat16", "none", "K3"),
             Candidate("stbp_core", "early_stop", "float32", "shot", "plain"),
             Candidate("K2", "fixed", "float32", "none", "K2"))


class Case(NamedTuple):
    """One selection point at one code: the (base) check matrix, rounds
    (None for flat BP), the column priors of the decoded matrix, shot counts,
    iterations and the QC dims (flat, or None)."""
    point: str
    code: str
    H: sparse.csr_matrix
    rounds: Optional[int]
    priors: np.ndarray
    shots: Sequence[int]
    iters: int
    qc_dims: Optional[tuple] = None


def _dem(rounds: int):
    """(fault matrix, fault priors) of HGP-225's ``rounds``-round
    circuit-noise detector model at :data:`DEM_P` (validate_dem's code)."""
    from .validate_dem import build_code, point_dem

    dsc = DetectorSpacetimeCode(point_dem(DEM_P, rounds, build_code()))
    return dsc.fault_check_matrix, np.asarray(dsc.fault_priors, dtype=np.float64)


def flat_case(code: str, H, p, qc_dims=None, shots=FLAT_SHOTS, iters=FLAT_ITERS) -> Case:
    """A flat case: column priors ``p`` (a scalar or one per column)."""
    H = sparse.csr_matrix(H)
    pri = np.full(H.shape[1], p) if np.isscalar(p) else np.asarray(p, dtype=np.float64)
    return Case("flat", code, H, None, pri, shots, iters, qc_dims)


def flat_cases() -> List[Case]:
    """The flat cases but the 4-round detector model (:func:`dem4_case`)."""
    out = [flat_case("gross_144_12_12", fam._gross_H(), 1e-3, (12, 6))]
    out += [flat_case(f"hgp_{nv * nv + (nv * 3 // 4) ** 2}", fam._hgp_H(nv, 42), 1e-3)
            for nv in (12, 16, 20, 32, 36)]
    out += [flat_case("qclp_1054_140", fam._qclp_H(), 1e-3, (31,)),
            flat_case("cyclic_lp_4862", fam._cyclic_H(), 1e-3),
            flat_case("hgp_10000", fam._hgp_H(80, 7), 1e-3),
            flat_case("hgp_15625", biregular_hgp(100, 3, 4, seed=0).checks.z, 5e-4),
            flat_case("hgp_40000", biregular_hgp(160, 3, 4, seed=11).checks.z, 5e-4)]
    hz = biregular_hgp(12, 3, 4, seed=0).checks.z
    q = 2 / 3 * 0.002
    HI = SpacetimeCodeSingleShot(hz).spacetime_check_matrix
    out.append(flat_case("hgp225_HI", HI, q))
    # the host redecode's regime: shots BP leaves unconverged (faults at 9x the prior)
    out.append(flat_case("hgp225_HI_hard", HI, 9 * q, shots=(685,)))
    out.append(flat_case("dem_1r", *_dem(1)))
    out += [flat_case(name, H, 1e-3) for name, H in width_probes()]
    return out


# HGP codes of (dv, dc)-biregular classical codes, whose checks hold dv + dc
# slots: 12, 18 and 20, between HGP n = 10,000's 7 and the cyclic lifted
# product's 24, with 1 or 2 shots of K6 a resident block on an H100
# (``bp_cuda.STREAMED_MIN_WIDTH``): (name, num_data, dv, dc).
WIDTH_PROBES = (("hgp_4500_w12", 60, 4, 8), ("hgp_8000_w12", 80, 4, 8),
                ("hgp_2880_w18", 48, 6, 12), ("hgp_4500_w18", 60, 6, 12),
                ("hgp_3200_w20", 40, 10, 10))


def width_probes() -> List[tuple]:
    """(name, Z check matrix) of each code of :data:`WIDTH_PROBES`."""
    return [(name, biregular_hgp(m, dv, dc, seed=0).checks.z) for name, m, dv, dc in WIDTH_PROBES]


def dem4_case(dem4) -> Case:
    """The 4-round detector model's case from ``_dem(4)``'s result."""
    return flat_case("dem_4r", *dem4)


def spacetime_case(code: str, H, rounds: int, p: float, shots, iters: int) -> Case:
    """A spacetime case: base matrix ``H`` over ``rounds`` rounds, the
    phenomenological priors 2p/3 of the pipeline."""
    st = SpacetimeCode(H, rounds)
    return Case("spacetime", code, sparse.csr_matrix(H), rounds,
                np.asarray(spacetime_prior(st, 2 / 3 * p, 2 / 3 * p), dtype=np.float64),
                shots, iters)


def spacetime_cases() -> List[Case]:
    """The spacetime cases (base check matrix, rounds, shots, iterations of
    their callers; ``hgp225_hard``: the host redecode's regime, faults at 3x
    the flagship's p, most shots run to the last iteration)."""
    hz = biregular_hgp(12, 3, 4, seed=0).checks.z
    st = spacetime_case
    return [st("hgp225", hz, 4, P_FLAGSHIP, (685, 16384), 48),
            st("hgp225_hard", hz, 4, 3 * P_FLAGSHIP, (685,), 48),
            st("hgp_400", fam._hgp_H(16, 42), 4, P_FLAGSHIP, (685, 16384), 48),
            st("hgp_625", fam._hgp_H(20, 42), 4, P_FLAGSHIP, (685, 16384), 48),
            st("hgp_1600", fam._hgp_H(32, 42), 4, P_FLAGSHIP, (685, 16384), 48),
            st("gross_144_12_12", gross_code(compute_logicals=False).checks.z, 12, 3e-3,
               (685, 16384), 60),
            st("cyclic_lp_4862", fam._cyclic_H(), 4, 2e-4, (512, 2048), 48),
            st("cyclic_lp_4862", fam._cyclic_H(), 8, 6e-4, (2048,), 64),
            st("hgp_10000", fam._hgp_H(80, 7), 8, 3e-4, (128,), 32),
            st("hgp_15625", biregular_hgp(100, 3, 4, seed=0).checks.z, 4, 3e-4, (128, 685), 32)]


def auto_candidate(case: Case, request: str, dev: torch.device) -> Candidate:
    """The candidate :mod:`..decoders.select` builds for the case on ``dev``
    when the caller asks ``request`` ("early_stop" or "fixed"): the decoder
    it names, with the exit as asked."""
    es = request == "early_stop"
    t = TannerELL.from_check_matrix(case.H)
    if case.rounds is None:
        name, pool = select.flat_choice(t, dev, early_stop=es), FLAT
    else:
        name, pool = select.spacetime_choice(t, case.rounds, dev, early_stop=es), SPACETIME
    (cand,) = [c for c in pool if (c.name, c.request) == (name, request)]
    return cand


def decoder(case: Case, cand: Candidate, dev: torch.device):
    """The candidate's decoder for the case, built by its public class."""
    es = cand.request == "early_stop"
    kw = dict(channel_probs=case.priors, max_iter=case.iters, bp_method="ms",
              ms_scaling_factor=ALPHA, early_stop=es, device=dev)
    if case.rounds is None:
        if cand.name == "K1":
            return BSRBPDecoder.from_check_matrix(case.H, **kw)
        if cand.name == "qc":
            return QCBPDecoder.from_check_matrix(case.H, case.qc_dims, **kw)
        return BPDecoder.from_check_matrix(case.H, **kw)
    cls = SpacetimeBSRDecoder if cand.name == "K3" else SpacetimeBPDecoder
    return cls.from_check_matrix(case.H, case.rounds, **kw)


def decoded_matrix(case: Case) -> sparse.csr_matrix:
    if case.rounds is None:
        return case.H
    return sparse.csr_matrix(SpacetimeCode(case.H, case.rounds).spacetime_check_matrix)


def plain_bytes(case: Case, S: int) -> float:
    """A bound on the plain cores' f32 temporaries at ``S`` shots: a few
    (edges x shots) arrays in the padded check-major and variable-major
    layouts."""
    t = TannerELL.from_check_matrix(decoded_matrix(case))
    return 4.0 * S * 6 * (t.num_checks * t.max_check_degree + t.num_vars * t.max_var_degree)


def draw_syndromes(M: sparse.csr_matrix, priors: np.ndarray, S: int, seed: int,
                   dev: torch.device) -> torch.Tensor:
    """(rows, S) uint8 syndromes of faults drawn on ``dev`` at the priors."""
    M = M.tocsr().astype(np.int64)
    Ms = torch.sparse_csr_tensor(torch.as_tensor(M.indptr), torch.as_tensor(M.indices),
                                 torch.ones(M.nnz, dtype=torch.float32), M.shape).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pri = torch.as_tensor(priors, dtype=torch.float32, device=dev)[:, None]
    err = (torch.rand((M.shape[1], S), generator=gen, device=dev) < pri).to(torch.float32)
    return torch.remainder(Ms @ err, 2.0).to(torch.uint8)


def _launched(before: Dict[str, Dict[str, int]]) -> Dict[str, Dict[str, int]]:
    out = {}
    for name, kern in KERNELS.items():
        diff = {r: n - before[name].get(r, 0) for r, n in kern.routes.items()
                if n - before[name].get(r, 0)}
        if diff:
            out[name] = diff
    return out


def _event_ms(fn: Callable[[], tuple]):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def measure(case: Case, S: int, cand: Candidate, repeats: int, dev: torch.device,
            card_info: dict, synds: Optional[List[torch.Tensor]] = None) -> dict:
    """One row: the candidate's ms per decode at ``S`` shots (median of
    ``repeats`` distinct batches after a warm-up; one batch where the warm-up
    took over 2 s), converged share, mean iterations, the kernel and route it
    launched."""
    M = decoded_matrix(case)
    row = {"point": case.point, "code": case.code, "checks": int(case.H.shape[0]),
           "n": int(case.H.shape[1]), "rounds": case.rounds, "matrix": list(M.shape),
           "shots": S, "iters": case.iters, "candidate": cand.name, "request": cand.request,
           "msg_dtype": cand.msg_dtype, "exit": cand.exit, "kernel": cand.kernel, **card_info}
    if cand.kernel == "plain" and plain_bytes(case, S) > PLAIN_BUDGET:
        row.update(ms=None, skipped=f"plain temporaries ~{plain_bytes(case, S) / 1e9:.0f} GB")
        return row
    if synds is None:
        synds = [draw_syndromes(M, case.priors, S, 1000 + i, dev) for i in range(repeats + 1)]
    try:
        dec = decoder(case, cand, dev)
        before = {k: dict(v.routes) for k, v in KERNELS.items()}
        out, warm = _event_ms(lambda: dec.decode_tensors(synds[-1]))
        launched = _launched(before)
        runs = synds[:1] if warm > 2000 else synds[:-1]
        times, conv, iters = [], [], []
        for s in runs:
            (_h, _p, c, it), ms = _event_ms(lambda s=s: dec.decode_tensors(s))
            times.append(ms)
            conv.append(float(c.float().mean()))
            iters.append(float(it.float().mean()))
        del out, dec
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        row.update(ms=None, skipped="out of device memory")
        return row
    torch.cuda.empty_cache()
    route = ",".join(f"{k}:{r}" for k, rs in launched.items() for r in rs) or "plain"
    if cand.kernel != "plain" and cand.kernel not in launched:
        raise AssertionError(f"{case.code} {cand}: kernel {cand.kernel} not launched "
                             f"({launched})")
    row.update(ms=float(np.median(times)), runs=len(times), route=route,
               converged=float(np.mean(conv)), iters_mean=float(np.mean(iters)))
    return row


def measure_turns(case: Case, S: int, cands: Sequence[Candidate], batches: int,
                  dev: torch.device) -> Dict[Candidate, List[float]]:
    """Every candidate's ms per decode at ``S`` shots, timed in turns on the
    same ``batches`` syndrome batches (the seeds of :func:`measure`): after
    one warm-up call each, each batch is decoded in the order a b .. b a, so
    every candidate sees each stretch of the host's load.  Returns every
    sample, per candidate."""
    M = decoded_matrix(case)
    synds = [draw_syndromes(M, case.priors, S, 1000 + i, dev) for i in range(batches)]
    decs = [decoder(case, c, dev) for c in cands]
    for dec in decs:
        dec.decode_tensors(synds[0])
    times: Dict[Candidate, List[float]] = {c: [] for c in cands}
    order = list(range(len(cands)))
    for s in synds:
        for i in order + order[::-1]:
            times[cands[i]].append(_event_ms(lambda: decs[i].decode_tensors(s))[1])
    del decs
    torch.cuda.empty_cache()
    return times


def card(dev: torch.device) -> dict:
    """The card's name, power limit (``nvidia-smi``) and opt-in shared
    memory per block and SM count (as the launch plans read them; the
    selection must read the same shared memory)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[dev.index or 0]
    bp_cuda.KERNEL.build()
    smem, sms = device_limits(bp_cuda.KERNEL, dev)
    if select.smem_optin(dev) != smem:
        raise AssertionError(f"the selection reads {select.smem_optin(dev)} B of shared memory "
                             f"per block, the card has {smem}")
    return {"device": torch.cuda.get_device_name(dev), "nvidia_smi": smi,
            "smem_optin": smem, "sm_count": sms}


def candidates(case: Case) -> Sequence[Candidate]:
    """The candidates of the case's selection point (the roll decoder only
    where the case has QC dims)."""
    if case.rounds is not None:
        return SPACETIME
    return [c for c in FLAT if c.name != "qc" or case.qc_dims is not None]


def run_cases(cases: Sequence[Case], repeats: int, dev: torch.device, info: dict,
              only: Optional[str] = None, write: Optional[str] = None,
              names: Optional[Sequence[str]] = None, tag: Optional[str] = None) -> List[dict]:
    rows = []
    for case in cases:
        if only and not any(o in f"{case.point}/{case.code}" for o in only.split(",")):
            continue
        M = decoded_matrix(case)
        for S in case.shots:
            synds = [draw_syndromes(M, case.priors, S, 1000 + i, dev)
                     for i in range(repeats + 1)]
            for cand in candidates(case):
                if names and cand.name not in names:
                    continue
                row = measure(case, S, cand, repeats, dev, info, synds)
                if tag is not None:
                    row["tag"] = tag
                print(json.dumps(row), flush=True)
                rows.append(row)
                if write:
                    with open(write, "a") as f:
                        f.write(json.dumps(row) + "\n")
            del synds
            torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated substrings of 'point/code' (e.g. "
                    "'flat/hgp_40000,spacetime')")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--candidates", default=None,
                    help="comma-separated candidate names to time (e.g. 'K2,K6'; default all)")
    ap.add_argument("--tag", default=None, help="a label added to every row")
    ap.add_argument("--write", default=None, metavar="PATH", help="append the rows here")
    args = ap.parse_args(argv)
    names = args.candidates.split(",") if args.candidates else None
    if not torch.cuda.is_available():
        raise SystemExit("bench_select measures a CUDA device; none is present")
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    with ThreadPoolExecutor(len(KERNELS)) as ex:   # one nvcc per source, all at once
        list(ex.map(lambda k: k.build(), KERNELS.values()))
    info = card(dev)
    want_dem4 = args.only is None or any(o in "flat/dem_4r" for o in args.only.split(","))
    pool = multiprocessing.get_context("spawn").Pool(1) if want_dem4 else None
    try:
        dem4 = pool.apply_async(_dem, (4,)) if pool else None
        rows = run_cases(spacetime_cases() + flat_cases(), args.repeats, dev, info, args.only,
                         args.write, names, args.tag)
        if dem4 is not None:
            rows += run_cases([dem4_case(dem4.get())], args.repeats, dev, info, None,
                              args.write, names, args.tag)
    finally:
        if pool is not None:
            pool.terminate()
    print(json.dumps({"rows": len(rows), **info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
