"""Whole sweep points of the port's ``p_sweep --pipeline``.

One unit of the window is ``_PipelineSweeper.run_point(p, batches x shots,
seed, i)``: it rebinds the pipeline's noise to the point, and batch j draws
from a generator seeded ``batch_seed(seed, i, j)``.  Each batch samples on
the card (``_sample``), decodes every shot there (``_decode_records``) and
redecodes the shots it ships with the corrector's BP+OSD
(``readout_correction_batch``); ``_finish_bposd`` folds the batch's
failures.  A traffic file's ``options`` go to the sweep's BP+OSD options
(``tier1_iters``, for one).
"""
from __future__ import annotations

from pathlib import Path

import torch

from ..capture import shipped_rows

WARMUP_POINT = 1 << 30   # a point index no window reaches


class Entry:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, root: Path):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, int(seed), device
        self.code_file = root / "benchmark" / "configs" / cfg["code"]["file"]
        self.p = float(traffic["p"])
        self.shots = int(cfg["shots_per_batch"])
        self.batches = int(traffic["batches_per_point"])
        self.sweeper = None

    def setup(self):
        from exp_ldpc_tpu_torch.circuits.noise import depolarizing_noise
        from exp_ldpc_tpu_torch.codes.io import read_quantum_code
        from exp_ldpc_tpu_torch.experiments.p_sweep import _PipelineSweeper

        with open(self.code_file) as f:
            code = read_quantum_code(f, validate_stabilizer_code=True)
        scale = float(self.cfg["prior_scale"])
        bp, osd = self.cfg["bp"], self.cfg["osd"]
        self.sweeper = _PipelineSweeper(
            code=code, rounds=int(self.cfg["rounds"]), noise_model=depolarizing_noise,
            noise_model_args=lambda p: {"p": p, "pm": p},
            meas_prior=lambda p, xs, zs: scale * p, data_prior=lambda p, xs, zs: scale * p,
            bp_osd_options={"max_iter": int(bp["max_iter"]), "bp_method": bp["method"],
                            "ms_scaling_factor": float(bp["ms_scaling_factor"]),
                            "osd_method": osd["method"], "osd_order": int(osd["order"]),
                            **self.traffic.get("options", {})},
            shots_per_device=self.shots, device=self.device, mode=self.traffic["mode"])
        # builds the pipeline and runs one batch of the cell's shapes, OSD included
        self.sweeper.run_point(self.p, self.shots, self.seed, WARMUP_POINT)

    def instrument(self, res, span):
        """Wrap the pipeline's layers: the spans of a traced run, and the
        outputs of the batches ``res`` keeps, each filed under its own batch
        by the tensors that flow from stage to stage (the record into the
        decode, the decode's compacted readout into the fold of the counts),
        and the calls nested in a stage by the batch that stage runs."""
        pipe = self.sweeper.pipe
        sample, decode, finish = pipe._sample, pipe._decode_records, pipe._finish_bposd
        build = pipe._build_osd_corrector

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
                keep["decoded"] = out
                res.tag(out[4], keep)
            return out

        def stage(kind, fn):
            def stage_w(*args, **kw):
                hard, conv = fn(*args, **kw)
                keep = res.active()
                if keep is not None:
                    keep["stages"].append((kind, hard, conv))
                return hard, conv
            return stage_w

        def finish_w(f_conv, shots, unconv, hist, readout, valid):
            keep = res.find(readout)
            res.enter(keep)
            try:
                out = finish(f_conv, shots, unconv, hist, readout, valid)
            finally:
                res.leave()
            if keep is not None:
                keep["failures"] = int(out[0])
            return out

        def corrector(c):
            orig = c.readout_correction_batch

            def correct_w(hist, readout):
                with span("host_osd"):
                    out = orig(hist, readout)
                keep = res.active()
                if keep is not None:
                    keep["corr"] = out
                return out
            c.readout_correction_batch = correct_w
            return c

        pipe._sample, pipe._decode_records, pipe._finish_bposd = sample_w, decode_w, finish_w
        pipe.decode_spacetime = stage("st", pipe.decode_spacetime)
        pipe.decode_flat = stage("flat", pipe.decode_flat)
        pipe._build_osd_corrector = lambda: corrector(build())
        corrector(pipe._osd)

    def run_unit(self, i: int) -> dict:
        _f, shots, osd = self.sweeper.run_point(self.p, self.batches * self.shots, self.seed, i)
        return {"shots": shots, "batches": self.batches, "osd_shots": osd}

    def captured(self, kept: list, exp, mode) -> list:
        """The kept batches in the form of ``benchmark/modes/shipped.py``;
        an output that never reached its batch stays None."""
        out = []
        for k in kept:
            hist, readout = exp.split(k["record"])
            item = {"record": k["record"], "ship": None, "unmatched": 0, "f_kept": None,
                    "corr": None, "dev_corr": None, "failures": k.get("failures")}
            if "decoded" in k:
                f_kept, _S, n_ship, hist_c, readout_c, _valid = k["decoded"]
                rows = torch.cat([hist.reshape(hist.shape[0], -1), readout], dim=1)
                ship_c = torch.cat([hist_c.reshape(hist_c.shape[0], -1), readout_c],
                                   dim=1)[:n_ship]
                ship, item["unmatched"] = shipped_rows(rows, ship_c)
                item["ship"], item["f_kept"] = ship.to(rows.device), int(f_kept)
            answer = mode.program_answer(exp, k.get("stages", []))
            if answer is not None:
                item["dev_corr"] = answer[0]
            if k.get("corr") is not None:
                item["corr"] = torch.as_tensor(k["corr"]).to(torch.uint8).to(readout.device)
            out.append(item)
        return out

    def release(self):
        self.sweeper = None
