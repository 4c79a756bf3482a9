"""Anchor rows of the three pipeline modes at p = 0.006, made by the JAX package on a CPU.

Runs the JAX package's ``exp_ldpc_tpu.experiments.p_sweep.p_sweep`` with
``pipeline={"mesh_devices": 1, "shots_per_device": --batch}`` on the CPU
for the modes ``bposd``, ``bposd_single_shot`` and ``bposd_hybrid`` on
HGP-225 over 4 rounds, phenomenological noise at p = 0.006 with the 2/3 p
priors and the options of ``artifacts/pipeline_modes_hgp225_v5e.csv``
(min-sum alpha 0.625, 48 iterations, OSD-CS order 7).  Each mode runs
``--shots`` shots in batches of ``--batch``, seeded ``--seed``; one JSON
row per mode is appended to ``--out``.

``--redecode`` sets the contract of the host BP+OSD redecode's BP:
``per_shot`` is the JAX package's own choice on a CPU (f32, each shot
frozen at its first convergence); ``fixed`` runs the same decoders at
fixed iterations (f32, ``early_stop=False`` through the JAX package's
``make_bp_decoder`` / ``make_spacetime_bp_decoder``), the contract the
port's selection runs on an H100 for HGP-225 (kernels K2 and K6).  The
device step is f32 at fixed iterations in both.  At p = 0.006 the
redecode's contract moves the hybrid mode's LER by ~10% (the rows of this
script on the same seeds: 3,857 failures of 65,536 with per-shot freezing,
3,498 at fixed iterations).

The code object is the one each gate of the port's ``chip_smoke.py`` runs:
``biregular_hgp(12, 3, 4, seed=0, compute_logicals=True)`` for ``bposd``
(phase 6) and ``artifacts/hgp225.qecc`` for the single-shot and hybrid
modes (phase 11), which gates on the ``fixed`` rows.
``pipeline_modes_hgp225_v5e.csv`` was taken while the host redecode ran
f32 per-shot-freezing BP, so its p = 0.006 rows cannot judge a redecode
with another contract.

    JAX_PLATFORMS=cpu PYTHONPATH=. python artifacts/make_pipeline_modes_jax_cpu.py
"""
from __future__ import annotations

import argparse
import json
import platform
import sys
import time
from pathlib import Path

MODES = ("bposd", "bposd_single_shot", "bposd_hybrid")
P = 0.006
ROUNDS = 4
OPTIONS = {"max_iter": 48, "bp_method": "ms", "ms_scaling_factor": 0.625,
           "osd_method": "osd_cs", "osd_order": 7}
CODE_FILE = Path(__file__).resolve().parent / "hgp225.qecc"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shots", type=int, default=32768)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=2000)
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--redecode", choices=("per_shot", "fixed"), default="fixed")
    ap.add_argument("--out", default="artifacts/pipeline_modes_jax_cpu.jsonl")
    args = ap.parse_args()

    import jax
    import numpy as np

    from exp_ldpc_tpu.circuits.noise import depolarizing_noise
    from exp_ldpc_tpu.codes.hgp import biregular_hgp
    from exp_ldpc_tpu.codes.io import read_quantum_code
    from exp_ldpc_tpu.decoders import select
    from exp_ldpc_tpu.experiments.p_sweep import p_sweep

    if args.redecode == "fixed":   # the drivers import these from select at each call
        def fixed(make):
            return lambda *a, **kw: make(*a, **dict(kw, early_stop=False))
        select.make_bp_decoder = fixed(select.make_bp_decoder)
        select.make_spacetime_bp_decoder = fixed(select.make_spacetime_bp_decoder)

    for mode in args.modes.split(","):
        if mode == "bposd":
            code, code_name = biregular_hgp(12, 3, 4, seed=0, compute_logicals=True), \
                "biregular_hgp(12, 3, 4, seed=0)"
        else:
            with CODE_FILE.open() as f:
                code = read_quantum_code(f, validate_stabilizer_code=True)
            code_name = "artifacts/hgp225.qecc"
        t0 = time.perf_counter()
        df = p_sweep(
            samples=args.shots, p_values=np.array([P]), noise_model=depolarizing_noise,
            noise_model_args=lambda p: {"p": p, "pm": p},
            meas_prior=lambda p, xs, zs: 2 / 3 * p, data_prior=lambda p, xs, zs: 2 / 3 * p,
            seed=args.seed, pipeline={"mesh_devices": 1, "shots_per_device": args.batch},
            code=code, rounds=ROUNDS, decoder_mode=mode, bp_osd_options=dict(OPTIONS))
        rec = df.iloc[0]
        failures, samples = int(rec["failures"]), int(rec["samples"])
        row = {"mode": mode, "code": code_name, "rounds": ROUNDS, "noise": "pheno", "p": P,
               "options": OPTIONS, "pipeline": {"mesh_devices": 1, "shots_per_device": args.batch},
               "redecode": args.redecode, "seed": args.seed, "failures": failures,
               "samples": samples,
               "ler": failures / samples, "walltime_s": time.perf_counter() - t0,
               "backend": f"jax {jax.__version__} cpu, {platform.machine()}",
               "command": " ".join(["JAX_PLATFORMS=cpu PYTHONPATH=. python"] + sys.argv)}
        print(json.dumps(row), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
