"""On-device Monte-Carlo step of the storage experiment.

Counterpart of ``exp_ldpc_tpu/parallel/pipeline.py::StorageDecodePipeline``
on one device.  One call of :meth:`StorageDecodePipeline.run_bposd`:

  1. samples Pauli frames on the device (:mod:`..sampler.device`);
  2. decodes by ``mode``, the algebra around the stages being
     :mod:`..decoders.memory`'s, which the BP+OSD drivers share:

     * ``"bposd"``: fixed-iteration spacetime BP, the kernel
       :func:`..decoders.select.spacetime_choice` names on a CUDA device:
       K2 (f32) where one shot of it fits shared memory, else K3
       (streamed, bf16);
     * ``"bposd_single_shot"``: flat BP on (H|I) each round, then on H;
     * ``"bposd_hybrid"``: spacetime BP (kernel K2 at every size: the
       streamed K3 contract serves mode ``"bposd"`` only, as in JAX), then
       flat BP of the final round on H;
     * ``"relay_bp"``: the relay BP ensemble (arXiv:2507.00254) on the
       flat spacetime matrix, mode ``"bposd"``'s algebra around it
       (:class:`..decoders.relay_bp.RelayBPDecoder`, kernel K10 on a CUDA
       device where its route takes the shape): no OSD and no host stage;
       a shot fails where its folded correction leaves a logical, solved
       or not.  Its options (``relay_legs``, ``relay_iters_per_leg``,
       ``relay_seed``, beside the BP keys) come in ``osd_options``, as
       :class:`..decoders.drivers.RelayBPCorrect` takes them, with the
       pipeline's ``bp_method`` and ``ms_scaling_factor`` (0 stands for 1);

     every flat stage without ``early_stop`` is kernel K6 on a CUDA device
     (its contract is that stage's); with ``early_stop`` the stages run the
     plain per-shot-freezing cores, as JAX does; on the CPU each kernel is
     replaced by its plain version.  With ``tier1_iters`` (mode
     ``"bposd"``) the spacetime stage is the two-tier decode: every shot at
     ``tier1_iters`` iterations, then the first ``tier2_cap`` shots of the
     stable order "unconverged first" redecoded from scratch at
     ``max_iter``; overflow shots keep their stage-1 result and count as
     unconverged;
  3. counts logical failures of the shots it keeps (in ``run``, without
     an OSD cap, of every shot, with one read of the counts from the card)
     and ships the others
     (compacted to the front, stable order) to the mode's BP+OSD driver
     (:mod:`..decoders.drivers`), which redecodes their rows where they
     lie; only their readout is copied to the host, a byte a cell, to fold
     the redecode's corrections.  Shipped: any shot with an unconverged
     stage in ``bposd`` and ``bposd_single_shot``, the shots whose
     final-round BP did not converge in ``bposd_hybrid``.

With a ``mesh`` (:mod:`.mesh`, model axis 1) each rank is one device of
the data axis: it samples its own ``shots_per_device`` shots with the
generator it is given, decodes them, redecodes its own shipped shots on
its host, and the counts are summed over the data group, so every rank
returns the totals.

Each step runs inside a span of :mod:`..utils.observability` (``ldpc.batch``
around ``ldpc.sample``, ``ldpc.decode`` with its ``decode.bp`` (or
``decode.relay``, the relay stage, with the counters ``relay_legs`` and
``relay_tail_shots`` read at the fold's read of the counts) and
``decode.fold``, and ``ldpc.ship``, the copy of the shipped readout to the
host, counted in ``ship_bytes``), which costs a flag read while tracing is
off.

``msg_dtype`` ("float32" or "bfloat16") is the message type of the plain
spacetime core (:func:`..decoders.spacetime_bp.stbp_core`), which runs
with ``early_stop`` and, for K2, on the CPU.  As in the JAX package, whose
Pallas kernels ignore the option, the kernels take precedence on the card:
K2 keeps f32 messages and K3 bf16 ones.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..circuits.ir import parse_circuit
from ..circuits.storage_sim import build_storage_simulation
from ..decoders.spacetime import SpacetimeCode, SpacetimeCodeSingleShot
from ..decoders.tanner import TannerELL
from ..sampler.reference import FrameSampler
from ..convert import noise_args, prior_llr_st, tanner_tables
from ..decoders.bp import bp_core, normalize_method, priors_to_llr
from ..decoders.bp_bsr_spacetime import stbsr_decode
from ..decoders.bp_cuda import bp_fixed
from ..decoders import memory
from ..decoders.drivers import (DECODER_MODES, RELAY_KEYS, check_options, relay_kwargs,
                                spacetime_prior)
from ..decoders.relay_bp import RelayBPDecoder
from ..decoders.select import spacetime_choice
from ..decoders.spacetime_bp import MSG_DTYPES, stbp_core
from ..decoders.spacetime_bp_cuda import stbp_fixed
from ..sampler.device import build_record_sampler
from ..utils.device import DeviceLike, resolve_device
from ..utils.observability import count, span
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, all_reduce_sum

__all__ = ["StorageDecodePipeline"]


@dataclass(eq=False)
class StorageDecodePipeline:
    """End-to-end sample+decode step for a storage experiment on one device.

    ``bp_backend`` picks the spacetime stage: ``"auto"`` (in mode
    ``"bposd"`` on a CUDA device the selection's K2 or K3, else K2), ``"stbp"``
    (K2) or ``"stbsr"`` (K3, mode ``"bposd"`` only); mode
    ``"bposd_single_shot"`` has no spacetime stage and mode ``"relay_bp"``
    no spacetime-BP stage: both take ``"auto"`` only.  ``kernel`` names the
    spacetime stage's choice (None without one, "relay" in mode
    ``"relay_bp"``), ``flat_kernel`` the flat stages' ("bpflat": K6,
    "core": plain early-stop BP; None in modes ``"bposd"`` and
    ``"relay_bp"``).  On a CPU device each kernel
    is replaced by its plain version.  ``run`` and ``run_bposd`` take a
    ``torch.Generator`` on the pipeline's device.
    """

    code: object
    rounds: int
    noise_model: object
    data_prior: float
    meas_prior: float
    shots_per_device: int
    max_iter: int = 40
    bp_method: str = "ps"
    ms_scaling_factor: float = 0.0
    mesh: Optional[Mesh] = None
    early_stop: bool = False
    bp_backend: str = "auto"
    osd_fallback_cap: int = 0
    osd_options: Optional[dict] = None
    use_x_logicals: bool = False
    mode: str = "bposd"
    msg_dtype: str = "float32"
    # > 0: the two-tier decode of mode "bposd" (module docstring); tier2_cap
    # defaults to max(128, shots_per_device // 4), clipped to the batch
    tier1_iters: int = 0
    tier2_cap: Optional[int] = None
    device: DeviceLike = "cuda"

    def __post_init__(self):
        if self.mesh is not None:
            if self.mesh.shape[MODEL_AXIS] != 1:
                raise ValueError("the pipeline shards shots over the data axis only; "
                                 f"got a model axis of {self.mesh.shape[MODEL_AXIS]}")
            self.device = self.mesh.device
        if self.mode not in ("bposd", "bposd_single_shot", "bposd_hybrid", "relay_bp"):
            raise ValueError(f"unknown pipeline mode {self.mode!r}")
        if self.mode == "relay_bp":
            check_options("StorageDecodePipeline(mode='relay_bp')", self.osd_options or {},
                          RELAY_KEYS)
            if self.osd_fallback_cap > 0:
                raise ValueError("mode='relay_bp' has no host stage: osd_fallback_cap must be 0")
            if self.early_stop:
                raise ValueError("mode='relay_bp' exits per shot at each leg's end; "
                                 "early_stop does not apply")
        if self.msg_dtype not in MSG_DTYPES:
            raise ValueError(f"msg_dtype must be one of {MSG_DTYPES}, got {self.msg_dtype!r}")
        if self.tier1_iters > 0:
            if self.mode != "bposd":
                raise ValueError("tier1_iters applies to mode='bposd' only")
            if self.early_stop:
                raise ValueError("tier1_iters requires early_stop=False (two fixed-shape passes)")
            if self.tier2_cap is None:
                self.tier2_cap = max(128, self.shots_per_device // 4)
            self.tier2_cap = min(self.tier2_cap, self.shots_per_device)
        if self.bp_backend not in ("auto", "stbp", "stbsr"):
            raise ValueError(f"unknown bp_backend {self.bp_backend!r}")
        self.device = resolve_device(self.device)
        self._method = normalize_method(self.bp_method)
        code = self.code
        sim = build_storage_simulation(
            self.rounds, self.noise_model, code, use_x_logicals=self.use_x_logicals)
        self.storage_sim = sim
        self.parsed = parse_circuit(sim.circuit)
        self.x_count = code.checks.x.shape[0]
        self.z_count = code.checks.z.shape[0]
        self.num_data = code.num_qubits
        checks_sector = code.checks.x if self.use_x_logicals else code.checks.z
        logicals = code.logicals.x if self.use_x_logicals else code.logicals.z
        self.spacetime = SpacetimeCode(checks_sector, self.rounds)
        self.tanner = TannerELL.from_check_matrix(checks_sector)
        self._tables = tanner_tables(self.tanner, self.device)
        self._tables_ss = None
        self._relay_tables = self._relay = None
        if self.mode == "relay_bp":
            self._relay_tables = tanner_tables(
                TannerELL.from_check_matrix(self.spacetime.spacetime_check_matrix), self.device)
        if self.mode == "bposd_single_shot":
            # per-round decode matrix (H|I): one measurement-error column per check
            H_ss = SpacetimeCodeSingleShot(checks_sector).spacetime_check_matrix
            self._tables_ss = tanner_tables(TannerELL.from_check_matrix(H_ss),
                                            self.device)
        dev = self.device
        self._Hz = torch.as_tensor(checks_sector.toarray().astype(np.float32)).to(dev)
        self._Lz_np = np.asarray(logicals, dtype=np.int64)
        self._Lz = torch.as_tensor(self._Lz_np.astype(np.float32)).to(dev)
        self._set_priors(self.data_prior, self.meas_prior)
        self._noise_args = noise_args(self.parsed, dev)
        self._sample = build_record_sampler(self.parsed, self.shots_per_device, dev)
        self.kernel = self._resolve_kernel()
        self.flat_kernel = None if self.mode in ("bposd", "relay_bp") else (
            "core" if self.early_stop else "bpflat")
        self._osd = None
        if self.osd_fallback_cap > 0:
            if self.osd_fallback_cap > self.shots_per_device:
                raise ValueError("osd_fallback_cap exceeds shots_per_device")
            self._osd = self._build_osd_corrector()

    def _resolve_kernel(self) -> Optional[str]:
        """The spacetime stage: "stbsr" (K3), "stbp" (K2), "core" (plain
        early-stop BP), "relay" (mode "relay_bp": the relay ensemble), or
        None in mode "bposd_single_shot"."""
        if self.mode == "relay_bp":
            if self.bp_backend != "auto":
                raise ValueError(f"bp_backend={self.bp_backend!r} applies to the spacetime-BP "
                                 "stage; relay_bp has none")
            return "relay"
        if self.mode == "bposd_single_shot":
            if self.bp_backend != "auto":
                raise ValueError(f"bp_backend={self.bp_backend!r} applies to the spacetime-BP "
                                 "stage; bposd_single_shot has none")
            return None
        if self.bp_backend == "stbsr":
            if self.mode != "bposd" or self.rounds < 1:
                raise ValueError("bp_backend='stbsr' needs mode='bposd' and rounds >= 1")
            if self.early_stop:
                raise ValueError("bp_backend='stbsr' requires early_stop=False (global-exit kernel)")
            return "stbsr"
        if self.early_stop:  # per-shot freezing: the plain core, no kernel
            if self.bp_backend == "stbp":
                raise ValueError("bp_backend='stbp' requires early_stop=False")
            return "core"
        if self.bp_backend == "stbp":
            return "stbp"
        if self.mode == "bposd" and spacetime_choice(self.tanner, self.rounds, self.device,
                                                     early_stop=False) == "K3":
            return "stbsr"
        return "stbp"

    def _set_priors(self, data_prior: float, meas_prior: float) -> None:
        """The spacetime priors, and the per-mode pair of the flat stages:
        (H|I) and final round for single-shot, final round for hybrid."""
        self.data_prior, self.meas_prior = data_prior, meas_prior
        self.prior_llr = priors_to_llr(spacetime_prior(self.spacetime, data_prior, meas_prior))
        self._prior = prior_llr_st(self.prior_llr, self.device)
        self._prior_ss = self._prior_final = None
        if self.mode == "relay_bp":
            opts = {"bp_method": self.bp_method, "ms_scaling_factor": self.ms_scaling_factor,
                    **(self.osd_options or {})}
            self._relay = RelayBPDecoder(self._relay_tables, self.prior_llr,
                                         **relay_kwargs(opts, 1.0))
            return
        if self.mode != "bposd":
            n = self.num_data
            self._prior_final = prior_llr_st(priors_to_llr(np.full(n, data_prior)), self.device)
        if self.mode == "bposd_single_shot":
            r = self._tables_ss.num_vars - self.num_data
            self._prior_ss = prior_llr_st(priors_to_llr(np.concatenate(
                [np.full(self.num_data, data_prior), np.full(r, meas_prior)])), self.device)

    def _build_osd_corrector(self):
        opts = dict(self.osd_options or {})
        opts.pop("tier1_iters", None)  # a pipeline option, checked in __post_init__
        opts.setdefault("max_iter", self.max_iter)
        opts.setdefault("bp_method", self.bp_method)
        opts.setdefault("ms_scaling_factor", self.ms_scaling_factor)
        return DECODER_MODES[self.mode](
            self.code, self.rounds, opts, (self.data_prior, self.meas_prior),
            basis="x" if self.use_x_logicals else "z", device=self.device)

    def decode_spacetime(self, synd: torch.Tensor, max_iter: Optional[int] = None):
        """(B·r, S) syndromes -> (hard (Vst, S) uint8, conv (S,) bool), at
        ``max_iter`` iterations (default the pipeline's)."""
        n_iter = self.max_iter if max_iter is None else int(max_iter)
        args = (self._tables, self.rounds, self._prior, synd, self._method, n_iter,
                float(self.ms_scaling_factor))
        with span("decode.bp"):
            if self.kernel == "stbsr":
                h, _p, c, _i = stbsr_decode(*args, early_stop=False)
            elif self.kernel == "stbp" and synd.device.type == "cuda":
                h, _p, c, _i = stbp_fixed(*args)
            else:   # the plain core: K2's plain version on the CPU, or per-shot freezing
                h, _p, c, _i = stbp_core(*args, early_stop=self.kernel == "core",
                                         msg_dtype=self.msg_dtype)
        return h, c

    def decode_two_tier(self, synd: torch.Tensor):
        """The two-tier spacetime decode of (B·r, S) syndromes: every shot at
        ``tier1_iters``, then the first ``tier2_cap`` shots of the stable
        order "unconverged first" redecoded from scratch at ``max_iter``;
        a redecoded shot takes its stage-2 result where stage 1 left it
        unconverged, and converged shots in the block keep theirs
        (``exp_ldpc_tpu/parallel/pipeline.py``, the same merge)."""
        hard, conv = self.decode_spacetime(synd, self.tier1_iters)
        order = torch.argsort(conv.to(torch.int32), stable=True)[: self.tier2_cap]
        hard2, conv2 = self.decode_spacetime(synd[:, order].contiguous(), self.max_iter)
        take = ~conv[order]
        hard[:, order] = torch.where(take[None], hard2, hard[:, order])
        conv[order] = conv[order] | conv2
        return hard, conv

    def decode_relay(self, synd: torch.Tensor):
        """The relay stage: (Vst-row, S) spacetime syndromes -> (hard (Vst,
        S) uint8, conv (S,) bool, solved leg (S,) int32, ``relay_legs``
        where no leg solved the shot)."""
        with span("decode.relay"):
            h, _p, c, leg = self._relay.decode_tensors(synd)
        return h, c, leg

    def decode_flat(self, tables, prior: torch.Tensor, synd: torch.Tensor):
        """A flat BP stage: (C, S) syndromes -> (hard (V, S) uint8, conv (S,) bool)."""
        args = (tables, prior, synd, self._method, self.max_iter, float(self.ms_scaling_factor))
        with span("decode.bp"):
            if self.flat_kernel == "bpflat":
                h, _p, c, _i = bp_fixed(*args)
            else:
                h, _p, c, _i = bp_core(*args, early_stop=True)
        return h, c

    def _split_record(self, record: torch.Tensor):
        """(S, M) record -> (history (S, rounds, r), readout (S, n)), f32."""
        S, rounds, n = record.shape[0], self.rounds, self.num_data
        r = self.x_count if self.use_x_logicals else self.z_count
        mpr = self.x_count + self.z_count
        blk = 0 if self.use_x_logicals else self.x_count
        rec = record.to(torch.float32)
        return (rec[:, : mpr * rounds].reshape(S, rounds, mpr)[:, :, blk: blk + r],
                rec[:, mpr * rounds: mpr * rounds + n])

    def _decode_records(self, record: torch.Tensor):
        """(S, M) record -> (failures, shots, unconverged) and, with the OSD
        fallback, the compacted (history, readout, ship) of up to cap shots."""
        with span("decode"):
            history, readout = self._split_record(record)
            final = lambda s: self.decode_flat(self._tables, self._prior_final, s)  # noqa: E731
            legs = []   # the relay stage's solving legs

            if self.mode == "relay_bp":
                def relay(s):
                    h, c, leg = self.decode_relay(s)
                    legs.append(leg)
                    return h, c
                stages = (relay,)
            elif self.mode == "bposd_single_shot":
                stages = (lambda s: self.decode_flat(self._tables_ss, self._prior_ss, s), final)
            else:
                st = ((lambda s: self.decode_two_tier(s)) if self.tier1_iters > 0
                      else lambda s: self.decode_spacetime(s))
                stages = (st, final) if self.mode == "bposd_hybrid" else (st,)
            correction, ok = memory.MODES[self.mode](self._Hz, history, readout, *stages)
            with span("decode.fold"):
                corrected = torch.remainder(readout + correction, 2.0)
                failed = (torch.remainder(corrected @ self._Lz.T, 2.0) > 0.5).any(dim=1)
                S = record.shape[0]
                if self.osd_fallback_cap <= 0:
                    counts = [failed.sum(), (~ok).sum()]
                    if legs:   # the deepest leg a shot ran, and the shots past leg 0
                        L = self._relay.num_legs
                        counts += [(legs[0] + 1).clamp(max=L).max().to(torch.int64),
                                   (legs[0] > 0).sum()]
                    counts = torch.stack(counts).tolist()   # the batch's one read
                    if legs:
                        count("relay_legs", counts[2])
                        count("relay_tail_shots", counts[3])
                    return int(counts[0]), S, int(counts[1])
                unconv = int((~ok).sum())
                order = torch.argsort(ok.to(torch.int32), stable=True)[: self.osd_fallback_cap]
                return (int((failed & ok).sum()), S, unconv, history[order], readout[order],
                        ~ok[order])

    def _data_sum(self, *counts: int):
        """The counts summed over the mesh's data group (unchanged without a mesh)."""
        if self.mesh is None:
            return counts
        t = torch.tensor(counts, dtype=torch.int64, device=self.device)
        return tuple(int(x) for x in all_reduce_sum(t, self.mesh.data_group).cpu())

    def run(self, generator: torch.Generator):
        """generator -> (logical_failures, total_shots, bp_unconverged_shots),
        summed over the mesh's data axis; with ``osd_fallback_cap`` set this
        is :meth:`run_bposd`."""
        if self.osd_fallback_cap > 0:
            return self.run_bposd(generator)
        with span("batch"):
            return self._data_sum(*self._decode_records(self._sample(generator,
                                                                     self._noise_args)))

    def run_bposd(self, generator: torch.Generator):
        """Device BP + host BP+OSD redecode of the BP failures:
        generator -> (logical_failures, total_shots, osd_decoded_shots),
        summed over the mesh's data axis."""
        if self._osd is None:
            raise ValueError("construct the pipeline with osd_fallback_cap > 0")
        with span("batch"):
            record = self._sample(generator, self._noise_args)
            return self._finish_bposd(*self._decode_records(record))

    def _finish_bposd(self, f_conv, shots, unconv, hist, readout, _valid):
        """The host redecode of a batch's shipped shots, the first
        ``min(unconv, cap)`` rows of ``_decode_records``' compacted
        (history, readout) as they lie on the device, and the batch's
        counts; ``_valid``, the compacted ship mask, is implied by them."""
        # the cap holds for the data axis as a whole, as in JAX; every rank
        # sees the same total and raises together
        n_data = 1 if self.mesh is None else self.mesh.shape[DATA_AXIS]
        (total_unconv,) = self._data_sum(unconv)
        if total_unconv > self.osd_fallback_cap * n_data:
            raise RuntimeError(f"{total_unconv} BP-unconverged shots exceed osd_fallback_cap="
                               f"{self.osd_fallback_cap} per device; raise the cap")
        # the stable order of _decode_records puts the shipped shots first
        k = min(unconv, hist.shape[0])
        if k == 0:
            count("ship_bytes", 0)
            return self._data_sum(f_conv, shots, 0)
        with span("ship"):
            # the shipped readout, a byte a cell, for the fold with _Lz_np
            shipped = readout[:k].to(torch.uint8).cpu().numpy()
            count("ship_bytes", shipped.nbytes)
        corr = self._osd.readout_correction_batch(hist[:k], readout[:k])
        flips = (((shipped + np.asarray(corr, dtype=np.int64)) % 2) @ self._Lz_np.T) % 2
        f_osd = int(np.any(flips != 0, axis=1).sum())
        return self._data_sum(f_conv + f_osd, shots, k)

    def rebind_noise(self, noise_model, data_prior: float, meas_prior: float):
        """New noise probabilities and priors for the same circuit structure;
        the op tables, Tanner tables and kernels are kept."""
        with span("rebind"):
            sim = build_storage_simulation(
                self.rounds, noise_model, self.code, use_x_logicals=self.use_x_logicals)
            parsed = parse_circuit(sim.circuit)
            if parsed.structure_signature() != self.parsed.structure_signature():
                raise ValueError("rebind_noise: circuit structure changed; build a new pipeline")
            self._noise_args = noise_args(parsed, self.device)
            self._set_priors(data_prior, meas_prior)
            self.noise_model = noise_model
            self.storage_sim = sim
            if self._osd is not None:
                with span("rebind.osd_build"):
                    self._osd = self._build_osd_corrector()
        return self

    def run_host_sampled(self, seed: int, shots: Optional[int] = None):
        """Same device decode, records from the CPU oracle sampler: isolates
        any statistical disagreement to the samplers.  Returns the first
        three outputs of the device step, as the JAX pipeline does."""
        S = shots if shots is not None else self.shots_per_device
        record = FrameSampler(self.storage_sim.circuit, seed=seed).sample(S)
        return self._decode_records(torch.as_tensor(record).to(self.device))[:3]
