"""Batches of the port's pipeline in mode ``relay_bp``, the relay BP
ensemble on the spacetime matrix as ``p_sweep --pipeline --decoder_mode
relay_bp`` runs it: ``bp_batch``'s units, seeds, capture and kept form, with
the relay stage (``decode_relay``) in place of the spacetime BP stage.  The
configuration's ``relay`` block gives the legs and the seed of the gamma
draw, its ``bp`` block the iterations a leg and the min-sum scaling.
"""
from __future__ import annotations

from .bp_batch import WARMUP_UNIT
from .bp_batch import Entry as BPEntry


class Entry(BPEntry):
    def setup(self):
        from exp_ldpc_tpu_torch.circuits.noise import depolarizing_noise
        from exp_ldpc_tpu_torch.codes.bivariate_bicycle import bivariate_bicycle_code
        from exp_ldpc_tpu_torch.parallel.pipeline import StorageDecodePipeline

        c, bp, relay = self.cfg["code"], self.cfg["bp"], self.cfg["relay"]
        code = bivariate_bicycle_code(c["l"], c["m"], [tuple(t) for t in c["a_terms"]],
                                      [tuple(t) for t in c["b_terms"]], compute_logicals=True)
        prior = float(self.cfg["prior_scale"]) * self.p
        self.pipe = StorageDecodePipeline(
            code=code, rounds=int(self.cfg["rounds"]),
            noise_model=depolarizing_noise(self.p, self.p), data_prior=prior, meas_prior=prior,
            shots_per_device=int(self.cfg["shots_per_batch"]), max_iter=int(bp["max_iter"]),
            bp_method=bp["method"], ms_scaling_factor=float(bp["ms_scaling_factor"]),
            osd_options={"relay_legs": int(relay["legs"]),
                         "relay_iters_per_leg": int(bp["max_iter"]),
                         "relay_seed": int(relay["seed"])},
            mode="relay_bp", device=self.device)
        self.pipe.run(self._gen(WARMUP_UNIT))

    def instrument(self, res, span):
        """``bp_batch``'s spans and capture; the relay stage's (hard, conv)
        filed under its batch as the stage ``relay``."""
        super().instrument(res, span)
        relay = self.pipe.decode_relay

        def relay_w(*args, **kw):
            out = relay(*args, **kw)
            keep = res.active()
            if keep is not None:
                keep["stages"].append(("relay", out[0], out[1]))
            return out

        self.pipe.decode_relay = relay_w
