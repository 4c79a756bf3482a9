"""Batches of the port's pipeline with BP only, as ``bench_gross`` runs it.

One unit of the window is one ``StorageDecodePipeline.run`` of a batch that
draws from a generator seeded ``batch_seed(seed, i, 0)``: the records are
sampled on the card (``_sample``) and every shot is decoded there
(``_decode_records``, whose spacetime stage is ``decode_spacetime``), which
counts the failures and the unconverged shots.
"""
from __future__ import annotations

from pathlib import Path

import torch

WARMUP_UNIT = 1 << 30   # a unit index no window reaches


class Entry:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, root: Path):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, int(seed), device
        self.p = float(traffic["p"])
        self.pipe = None

    def _gen(self, i: int) -> torch.Generator:
        from exp_ldpc_tpu_torch.experiments.p_sweep import batch_seed

        g = torch.Generator(device=self.pipe.device)
        g.manual_seed(batch_seed(self.seed, i, 0))
        return g

    def setup(self):
        from exp_ldpc_tpu_torch.circuits.noise import depolarizing_noise
        from exp_ldpc_tpu_torch.codes.bivariate_bicycle import bivariate_bicycle_code
        from exp_ldpc_tpu_torch.parallel.pipeline import StorageDecodePipeline

        c, bp = self.cfg["code"], self.cfg["bp"]
        code = bivariate_bicycle_code(c["l"], c["m"], [tuple(t) for t in c["a_terms"]],
                                      [tuple(t) for t in c["b_terms"]], compute_logicals=True)
        prior = float(self.cfg["prior_scale"]) * self.p
        self.pipe = StorageDecodePipeline(
            code=code, rounds=int(self.cfg["rounds"]),
            noise_model=depolarizing_noise(self.p, self.p), data_prior=prior, meas_prior=prior,
            shots_per_device=int(self.cfg["shots_per_batch"]), max_iter=int(bp["max_iter"]),
            bp_method=bp["method"], ms_scaling_factor=float(bp["ms_scaling_factor"]),
            msg_dtype=self.cfg["precision"]["device_stage"], device=self.device)
        self.pipe.run(self._gen(WARMUP_UNIT))

    def instrument(self, res, span):
        pipe = self.pipe
        sample, decode, spacetime = pipe._sample, pipe._decode_records, pipe.decode_spacetime

        def sample_w(gen, args):
            with span("sampler"):
                record = sample(gen, args)
            res.offer(record)
            return record

        def decode_w(record):
            keep = res.find(record)
            if keep is not None:
                keep["stages"] = []
            res.enter(keep)
            try:
                with span("decode"):
                    out = decode(record)
            finally:
                res.leave()
            if keep is not None:
                keep["failures"] = int(out[0])
            return out

        def spacetime_w(*args, **kw):
            hard, conv = spacetime(*args, **kw)
            keep = res.active()
            if keep is not None:
                keep["stages"].append(("st", hard, conv))
            return hard, conv

        pipe._sample, pipe._decode_records, pipe.decode_spacetime = sample_w, decode_w, spacetime_w

    def run_unit(self, i: int) -> dict:
        _f, shots, _unconv = self.pipe.run(self._gen(i))
        return {"shots": shots, "batches": 1}

    def captured(self, kept: list, exp, mode) -> list:
        """The kept batches in the form of ``benchmark/modes/bp.py``; an
        output that never reached its batch stays None."""
        out = []
        for k in kept:
            answer = mode.program_answer(exp, k.get("stages", []))
            dev_corr, ship = answer if answer is not None else (None, None)
            out.append({"record": k["record"], "dev_corr": dev_corr, "ship": ship,
                        "failures": k.get("failures")})
        return out

    def release(self):
        self.pipe = None
