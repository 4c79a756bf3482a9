"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # the full check, one card
    python3 chip_smoke.py --quick    # build + kernel parity at a small size only

Phases, in order; any failure raises and exits nonzero:
  1. versions and the card (``nvidia-smi`` name and power limit);
  2. build kernels K2 (``csrc/stbp.cu``) and K3 (``csrc/stbsr.cu``) from source;
  3. K2 against its plain PyTorch version on the card, at a ragged shot
     count (685, the host redecode's size), 4,096 and the main path's
     16,384 shots: hard decisions, conv and iters equal, posteriors equal
     to 1e-6*max(1,|x|);
  4. K3 against its plain PyTorch version, at the same sizes and bounds;
  5. the device sampler: noiseless circuit -> zero detectors; detector rates
     against the host oracle ``FrameSampler``;
  6. the main path: ``p_sweep(..., pipeline=...)`` on HGP-225, 4 rounds,
     min-sum 48 iterations, OSD-CS 7, at two grid points of
     ``artifacts/ler_hgp225_bposd_v5e.jsonl``, each LER within 4 combined
     binomial sigma of the artifact, through K3;
  7. the same pipeline on K2 (``bp_backend="stbp"``); the launch counts of
     phases 6 and 7 together are the main path's;
  8. timings (CUDA events, median of 5 distinct-input runs).

The line before the last is the kernel summary JSON (``launches`` from
phases 6-7, ``launches_by_run`` split by phase; without ``--quick`` only,
as are the times); the last line is
``{"ok": true, "device": {...}}``.  It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import logging
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# Everything is read from the checkout this script stands in (never from an
# installed copy): without the port, the host modules it shares and the
# artifact beside it, the script refuses to run.
if not all((ROOT / d).is_dir() for d in ("exp_ldpc_tpu_torch", "exp_ldpc_tpu", "artifacts")):
    sys.exit(f"chip_smoke.py must run from the root of a checkout of the repository ({ROOT})")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from exp_ldpc_tpu_torch import _host  # noqa: E402
from exp_ldpc_tpu_torch.convert import tanner_tables  # noqa: E402
from exp_ldpc_tpu_torch.decoders import bp_bsr_spacetime as k3  # noqa: E402
from exp_ldpc_tpu_torch.decoders import spacetime_bp_cuda as k2  # noqa: E402
from exp_ldpc_tpu_torch.decoders.bp import priors_to_llr  # noqa: E402
from exp_ldpc_tpu_torch.decoders.spacetime_bp import stbp_core  # noqa: E402
from exp_ldpc_tpu_torch.experiments.p_sweep import p_sweep  # noqa: E402
from exp_ldpc_tpu_torch.parallel.pipeline import StorageDecodePipeline  # noqa: E402
from exp_ldpc_tpu_torch.sampler.device import DeviceSampler  # noqa: E402

ARTIFACT = ROOT / "artifacts" / "ler_hgp225_bposd_v5e.jsonl"
ROUNDS = 4
MAX_ITER = 48
ALPHA = 0.625
OPTIONS = dict(max_iter=MAX_ITER, bp_method="ms", ms_scaling_factor=ALPHA,
               osd_method="osd_cs", osd_order=7)
P_LO, P_HI = 0.0015157165665103977, 0.0034822022531844966
# ~ the BP-unconverged shots per 16,384-shot batch at P_HI: the ragged size
# at which the host BP+OSD redecode runs K3
S_REDECODE = 685


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    log(f"  ok: {what}")


class Setup:
    """HGP-225 Z sector, 4 rounds: tables, priors and the spacetime matrix."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.code = _host.biregular_hgp(12, 3, 4, seed=0, compute_logicals=True)
        H = self.code.checks.z
        self.tables = tanner_tables(_host.TannerELL.from_check_matrix(H), dev)
        st = _host.SpacetimeCode(H, ROUNDS)
        self.Hst = st.spacetime_check_matrix.tocsr().astype(np.int64)
        self.Hst_dev = torch.as_tensor(self.Hst.toarray().astype(np.float32)).to(dev)

    def prior(self, p: float) -> torch.Tensor:
        llr = priors_to_llr(np.full(self.Hst.shape[1], 2 / 3 * p))
        return torch.as_tensor(llr).to(self.dev)

    def syndromes(self, S: int, p: float, seed: int) -> torch.Tensor:
        """(B·r, S) uint8 syndromes of i.i.d. spacetime errors at rate p."""
        rng = np.random.default_rng(seed)
        err = (rng.random((S, self.Hst.shape[1])) < p).astype(np.int64)
        synd = (self.Hst @ err.T) % 2
        return torch.as_tensor(synd.astype(np.uint8)).to(self.dev)

    def valid(self, hard: torch.Tensor, synd: torch.Tensor) -> torch.Tensor:
        par = torch.remainder(self.Hst_dev @ hard.to(torch.float32), 2.0)
        return (par == synd.to(torch.float32)).all(dim=0)


def phase_card() -> str:
    log("== phase 1: versions and card")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py runs on a GPU only")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(smi.splitlines()[0])
    return smi.splitlines()[0]


def phase_build() -> None:
    log("== phase 2: build kernels")
    for kern in (k2.KERNEL, k3.KERNEL):
        kern.build()
        log(f"built {kern.source.name} in {kern.build_seconds:.1f} s")
        for line in kern.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log("  " + line.strip())


def _same(tag: str, su: Setup, synd, kern, plain) -> float:
    """Kernel outputs ``kern`` against plain outputs ``plain``, both
    (hard, posterior, conv, iters).  The kernels round where their plain
    versions do (``--fmad=false``, the same left-to-right sums, bf16 at the
    same points), so hard decisions, conv and iters must be equal and
    posteriors equal to 1e-6*max(1,|x|).  Those bounds contain the stated
    ones (K2: posterior 1e-3*max(1,|x|), hard and conv agreement >= 99.9%;
    K3: hard >= 99.9%, conv >= 99%); the agreement shares are printed."""
    hk, pk, ck, ik = kern
    hp, pp, cp, ip = plain
    err = (pk - pp).abs()
    worst = float(err.max())
    log(f"  {tag}: max|dpost| {worst:.3g}, hard agree {float((hk == hp).float().mean()):.6f}, "
        f"conv agree {float((ck == cp).float().mean()):.6f}, conv rate "
        f"{float(cp.float().mean()):.4f}, iters {int(ik.max())}/{int(ip.max())}")
    check(bool((err <= 1e-6 * pp.abs().clamp(min=1.0)).all()),
          f"{tag}: posterior within 1e-6*max(1,|x|) of plain")
    check(torch.equal(hk, hp), f"{tag}: hard decisions equal to plain")
    check(torch.equal(ck, cp), f"{tag}: conv equal to plain")
    check(torch.equal(ik, ip), f"{tag}: iters equal to plain")
    check(bool(su.valid(hk, synd)[ck].all()), f"{tag}: every conv=1 shot satisfies its syndrome")
    return worst


def phase_k2(su: Setup, sizes) -> float:
    log(f"== phase 3: K2 vs plain, S in {sizes}, {MAX_ITER} iterations")
    p = 3e-3
    prior = su.prior(p)
    worst = 0.0
    for S in sizes:
        synd = su.syndromes(S, p, seed=1)
        for method, msf in (("ms", ALPHA), ("ms", 0.0), ("ps", 0.0)):
            kern = k2.stbp_fixed(su.tables, ROUNDS, prior, synd, method, MAX_ITER, msf)
            plain = stbp_core(su.tables, ROUNDS, prior, synd, method, MAX_ITER, msf,
                              early_stop=False)
            torch.cuda.synchronize()
            worst = max(worst, _same(f"S={S} {method} alpha={msf}", su, synd, kern, plain))
    return worst


def phase_k3(su: Setup, sizes) -> float:
    log(f"== phase 4: K3 vs plain (bf16 messages), S in {sizes}, {MAX_ITER} iterations")
    p = 3e-3
    prior = su.prior(p)
    worst = 0.0
    cases = (("ms", ALPHA, False), ("ms", 0.0, False), ("ps", 0.0, False), ("ms", ALPHA, True))
    for S in sizes:
        synd = su.syndromes(S, p, seed=2)
        for method, msf, es in cases:
            kern = k3.stbsr_decode(su.tables, ROUNDS, prior, synd, method, MAX_ITER, msf, es)
            plain = k3.stbsr_decode(su.tables, ROUNDS, prior, synd, method, MAX_ITER, msf, es,
                                    iterate=k3._stbsr_iter_plain)
            torch.cuda.synchronize()
            worst = max(worst, _same(f"S={S} {method} alpha={msf} early_stop={es}", su, synd,
                                     kern, plain))
    return worst


def phase_sampler(su: Setup, dev: torch.device, quick: bool) -> None:
    log("== phase 5: device sampler")
    quiet = _host.build_storage_simulation(ROUNDS, _host.noise.trivial_noise(), su.code)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    det = DeviceSampler(quiet.circuit, 4096, dev).sample_detectors(gen, append_observables=True)
    check(int(det.sum()) == 0, "noiseless circuit: all detectors and observables are 0")
    p = 3e-3
    sim = _host.build_storage_simulation(ROUNDS, _host.depolarizing_noise(p, p), su.code)
    n_dev, n_host = (8192, 2048) if quick else (65536, 16384)
    ds = DeviceSampler(sim.circuit, n_dev, dev)
    rate_dev = ds.sample_detectors(gen).to(torch.float64).mean(dim=0).cpu().numpy()
    rate_host = _host.FrameSampler(sim.circuit, seed=7).sample_detectors(n_host).mean(axis=0)
    pooled = (rate_dev * n_dev + rate_host * n_host) / (n_dev + n_host)
    sigma = np.sqrt(pooled * (1 - pooled) * (1 / n_dev + 1 / n_host))
    z = np.abs(rate_dev - rate_host) / np.where(sigma > 0, sigma, 1.0)
    log(f"  {rate_dev.size} detectors, mean rate device {rate_dev.mean():.5f} host "
        f"{rate_host.mean():.5f}, max |z| {z.max():.2f}")
    check(bool((z <= 5.0).all()), "every detector rate within 5 sigma of FrameSampler")


def artifact_point(p: float) -> dict:
    for line in ARTIFACT.read_text().splitlines():
        rec = json.loads(line)
        if "p_ph" in rec and abs(rec["p_ph"] - p) < 1e-15:
            return rec
    raise KeyError(p)


def ler_within(failures: int, samples: int, p: float, k: float = 4.0) -> bool:
    art = artifact_point(p)
    l1, n1 = failures / samples, samples
    l2, n2 = art["ler"], art["samples"]
    sigma = np.sqrt(l1 * (1 - l1) / n1 + l2 * (1 - l2) / n2)
    log(f"  p={p:.6g}: LER {l1:.5f} ({failures}/{samples}) vs artifact {l2:.5f}, "
        f"|diff| = {abs(l1 - l2) / sigma:.2f} sigma")
    return abs(l1 - l2) <= k * sigma


class _PointLog(logging.Handler):
    """Collects the per-point log records of p_sweep (p, failures, shots, OSD-decoded, s)."""

    def __init__(self):
        super().__init__()
        self.points = []

    def emit(self, record):
        self.points.append(record.args)


def phase_main_path(su: Setup, dev: torch.device, samples: int, shots: int) -> dict:
    log(f"== phase 6: main path p_sweep, {samples} shots per point, batch {shots}")
    handler = _PointLog()
    lg = logging.getLogger("exp_ldpc_tpu_torch.p_sweep")
    lg.addHandler(handler)
    lg.setLevel(logging.INFO)
    before = launch_counts()
    records = p_sweep(
        samples=samples, p_values=np.array([P_LO, P_HI]),
        noise_model=_host.depolarizing_noise,
        noise_model_args=lambda p: {"p": p, "pm": p},
        meas_prior=lambda p, xs, zs: 2 / 3 * p, data_prior=lambda p, xs, zs: 2 / 3 * p,
        seed=0, pipeline={"mesh_devices": 1, "shots_per_device": shots}, device=dev,
        code=su.code, rounds=ROUNDS, decoder_mode="bposd", bp_osd_options=dict(OPTIONS))
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    lg.removeHandler(handler)
    log(f"  kernel launches during the sweep: {launches}")
    for (p, f, n, osd, secs) in handler.points:
        log(f"  p={p:.6g}: failures {f}, shots {n}, OSD-decoded {osd}, "
            f"{n / secs:.0f} decoded shots/s ({secs:.2f} s)")
    for rec in records:
        check(ler_within(rec["failures"], rec["samples"], rec["p_ph"]),
              f"p={rec['p_ph']:.6g}: LER within 4 sigma of the artifact")
    check(launches["K3"] > 0, "K3 launched on the main path")
    return launches


def phase_k2_pipeline(su: Setup, dev: torch.device, shots: int) -> dict:
    log(f"== phase 7: pipeline on K2 (bp_backend='stbp'), {shots} shots at p={P_HI:.6g}")
    p = P_HI
    pipe = StorageDecodePipeline(
        code=su.code, rounds=ROUNDS, noise_model=_host.depolarizing_noise(p, p),
        data_prior=2 / 3 * p, meas_prior=2 / 3 * p, shots_per_device=shots,
        max_iter=MAX_ITER, bp_method="ms", ms_scaling_factor=ALPHA, bp_backend="stbp",
        osd_fallback_cap=shots, osd_options=dict(OPTIONS), device=dev)
    check(pipe.kernel == "stbp", "pipeline resolved to K2")
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    before = launch_counts()
    f, n, osd = pipe.run_bposd(gen)
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    log(f"  failures {f}, shots {n}, OSD-decoded {osd}, kernel launches {launches}")
    check(launches["K2"] > 0, "K2 launched on the pipeline")
    check(ler_within(f, n, p), "K2 pipeline LER within 4 sigma of the artifact")
    return launches


def launch_counts() -> dict:
    return {"K2": k2.KERNEL.launches, "K3": k3.KERNEL.launches}


def _median_ms(fn, inputs) -> float:
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


def phase_timings(su: Setup, dev: torch.device, shots: int) -> dict:
    log(f"== phase 8: timings, S={shots}, {MAX_ITER} iterations, median of 5")
    p = P_HI
    prior = su.prior(p)
    synds = [su.syndromes(shots, p, seed=100 + i) for i in range(6)]
    args = (su.tables, ROUNDS, prior)
    warm = synds[5]
    t = {}
    k2.stbp_fixed(*args, warm, "ms", MAX_ITER, ALPHA)
    stbp_core(*args, warm, "ms", MAX_ITER, ALPHA, early_stop=False)
    t["K2"] = _median_ms(lambda s: k2.stbp_fixed(*args, s, "ms", MAX_ITER, ALPHA), synds[:5])
    t["K2_plain"] = _median_ms(
        lambda s: stbp_core(*args, s, "ms", MAX_ITER, ALPHA, early_stop=False), synds[:5])
    k3.stbsr_decode(*args, warm, "ms", MAX_ITER, ALPHA, False)
    t["K3"] = _median_ms(lambda s: k3.stbsr_decode(*args, s, "ms", MAX_ITER, ALPHA, False),
                         synds[:5])
    plain = k3._stbsr_iter_plain
    k3.stbsr_decode(*args, warm, "ms", MAX_ITER, ALPHA, False, iterate=plain)
    t["K3_plain"] = _median_ms(
        lambda s: k3.stbsr_decode(*args, s, "ms", MAX_ITER, ALPHA, False, iterate=plain),
        synds[:5])
    # K3 at the ragged size of the host BP+OSD redecode
    small = [x[:, :S_REDECODE].contiguous() for x in synds]
    t[f"K3_S{S_REDECODE}"] = _median_ms(
        lambda s: k3.stbsr_decode(*args, s, "ms", MAX_ITER, ALPHA, False), small[:5])
    t[f"K3_S{S_REDECODE}_plain"] = _median_ms(
        lambda s: k3.stbsr_decode(*args, s, "ms", MAX_ITER, ALPHA, False, iterate=plain),
        small[:5])
    sim = _host.build_storage_simulation(ROUNDS, _host.depolarizing_noise(p, p), su.code)
    ds = DeviceSampler(sim.circuit, shots, dev)
    gens = []
    for i in range(6):
        g = torch.Generator(device=dev)
        g.manual_seed(200 + i)
        gens.append(g)
    ds.sample(gens[5])
    t["sampler"] = _median_ms(ds.sample, gens[:5])
    pipe = StorageDecodePipeline(
        code=su.code, rounds=ROUNDS, noise_model=_host.depolarizing_noise(p, p),
        data_prior=2 / 3 * p, meas_prior=2 / 3 * p, shots_per_device=shots,
        max_iter=MAX_ITER, bp_method="ms", ms_scaling_factor=ALPHA,
        osd_fallback_cap=shots, osd_options=dict(OPTIONS), device=dev)
    pipe.run_bposd(gens[5])
    # run_bposd = sample, device decode (syndromes, BP, failure count, OSD
    # compaction), host BP+OSD of the unconverged shots; timed stage by stage
    stages = {"sample": [], "device_decode": [], "host_osd": [], "e2e": []}
    for g in gens[:5]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        record = pipe._sample(g, pipe._noise_args)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = pipe._decode_records(record)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        pipe._finish_bposd(*out)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, v in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t3 - t0)):
            stages[k].append(v)
    for k, v in stages.items():
        t[f"{k}_s"] = float(np.median(v))
    for k, v in t.items():
        log(f"  {k}: {v:.4f}" + (" s" if k.endswith("_s") else " ms"))
    log(f"  end to end: {shots / t['e2e_s']:.0f} decoded shots/s at p={p:.6g}")
    return t


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="build, kernel parity at small sizes and the sampler only "
                    "(a first check of new kernels)")
    args = ap.parse_args()
    smi = phase_card()
    dev = torch.device("cuda")
    phase_build()
    su = Setup(dev)
    # ragged shot edges (97, S_REDECODE) and the main path's batch (16,384)
    sizes = (97, 512) if args.quick else (S_REDECODE, 4096, 16384)
    err = {"K2": phase_k2(su, sizes), "K3": phase_k3(su, sizes)}
    phase_sampler(su, dev, args.quick)
    kernels = [
        {"name": "K2 stbp_fixed", "route": "cuda", "source": "exp_ldpc_tpu_torch/csrc/stbp.cu",
         "replaces": "exp_ldpc_tpu/decoders/spacetime_bp_pallas.py:65"},
        {"name": "K3 stbsr_iter", "route": "cuda", "source": "exp_ldpc_tpu_torch/csrc/stbsr.cu",
         "replaces": "exp_ldpc_tpu/decoders/bp_bsr_spacetime.py:113"},
    ]
    if not args.quick:
        # The main path: the p_sweep (bp_backend "auto", K3 at HGP-225) and
        # the same pipeline with bp_backend "stbp" (K2), counted from 0 here.
        k2.KERNEL.launches = k3.KERNEL.launches = 0
        by_run = {"p_sweep": phase_main_path(su, dev, samples=65536, shots=16384),
                  "pipeline_stbp": phase_k2_pipeline(su, dev, shots=16384)}
        launches = launch_counts()
        for name, n in launches.items():
            check(n > 0, f"{name} launched on the main path ({n} launches)")
        t = phase_timings(su, dev, shots=16384)
        for kern in kernels:
            key = kern["name"][:2]
            kern.update(launches=launches[key],
                        launches_by_run={run: c[key] for run, c in by_run.items()},
                        ms=t[key], plain_ms=t[f"{key}_plain"])
    for kern in kernels:
        kern["max_abs_err"] = err[kern["name"][:2]]
    log(f"card: {smi}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
