"""Anchor rows of ``run_simulation`` modes that have no other LER reference.

Runs the JAX package's ``exp_ldpc_tpu.decoders.drivers.run_simulation`` on
the CPU with the host ``FrameSampler`` (``use_device_sampler=False``) for the
modes ``relay_bp``, ``ssf_single_shot`` and ``bpd_detector`` on HGP-225
(``biregular_hgp(12, 3, 4, seed=0)``), 4 rounds, phenomenological noise at
p = 0.002 with the 2/3 p priors, and the options of
``tests/test_decoders.py::test_run_simulation_modes`` with min-sum.  Each
mode runs ``--chunks`` batches of ``--shots`` shots, batch k seeded
``--seed + k``; one JSON row per mode is appended to ``--out``.  The port's
``chip_smoke.py`` gates its own runs of these modes against the rows, on the
same code object: a mode that leaves shots unconverged (small-set-flip)
scores them with the code's logical representatives, and
``artifacts/hgp225.qecc`` holds other representatives than
``biregular_hgp(12, 3, 4, seed=0, compute_logicals=True)``.

    JAX_PLATFORMS=cpu PYTHONPATH=. python artifacts/make_run_simulation_modes_jax_cpu.py
"""
from __future__ import annotations

import argparse
import json
import platform
import sys
import time

MODES = ("relay_bp", "ssf_single_shot", "bpd_detector")
P = 0.002
ROUNDS = 4
OPTIONS = {"max_iter": 40, "bp_method": "ms", "ms_scaling_factor": 0,
           "osd_method": "osd_cs", "osd_order": 4}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shots", type=int, default=4096)
    ap.add_argument("--chunks", type=int, default=8)
    ap.add_argument("--seed", type=int, default=1000)
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--out", default="artifacts/run_simulation_modes_jax_cpu.jsonl")
    args = ap.parse_args()

    import jax

    from exp_ldpc_tpu.circuits.noise import depolarizing_noise
    from exp_ldpc_tpu.codes.hgp import biregular_hgp
    from exp_ldpc_tpu.decoders.drivers import run_simulation

    code = biregular_hgp(12, 3, 4, seed=0, compute_logicals=True)
    for mode in args.modes.split(","):
        failures = samples = 0
        t0 = time.perf_counter()
        for k in range(args.chunks):
            fails = run_simulation(
                samples=args.shots, code=code,
                meas_prior=lambda xs, zs: 2 / 3 * P, data_prior=lambda xs, zs: 2 / 3 * P,
                noise_model=depolarizing_noise, noise_model_args={"p": P, "pm": P},
                bp_osd_options=dict(OPTIONS), rounds=ROUNDS, decoder_mode=mode,
                seed=args.seed + k, use_device_sampler=False)
            failures += int(sum(fails))
            samples += len(fails)
        row = {"mode": mode, "code": "hgp225", "rounds": ROUNDS, "noise": "pheno", "p": P,
               "options": OPTIONS, "sampler": "FrameSampler", "seeds": [args.seed, args.seed
                                                                         + args.chunks - 1],
               "failures": failures, "samples": samples, "ler": failures / samples,
               "walltime_s": time.perf_counter() - t0,
               "backend": f"jax {jax.__version__} cpu, {platform.machine()}",
               "command": " ".join(["JAX_PLATFORMS=cpu PYTHONPATH=. python"] + sys.argv)}
        print(json.dumps(row), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
