"""Decode-mode drivers and the end-to-end Monte-Carlo simulation of the port.

Counterpart of ``exp_ldpc_tpu/decoders/drivers.py``: the seven decode modes
(``bposd``: BP+OSD on the full spacetime matrix; ``bposd_single_shot``:
per-round (H|I) BP+OSD with an accumulated correction, then the final
round; ``bposd_hybrid``: spacetime BP, then BP+OSD of the final round;
``bpd_detector``: BP on the detector error model's fault matrix;
``relay_bp``: the relay BP ensemble on the spacetime matrix;
``ssf_single_shot``: per-round small-set-flip; ``sliding_window``:
overlapping-window BP+OSD), :func:`run_simulation` (build the storage
circuit, sample, decode every shot, count logical failures) and the CLI
helpers.  Every decoder runs on ``device`` (the card unless the caller asks
for the CPU, where each kernel is replaced by its plain version); OSD runs
on the card where kernel K8 takes the shape, else on the host.  The three
BP+OSD modes and ``ssf_single_shot`` run the algebra of
:mod:`.memory` on tensors on ``device``: they take numpy or tensors and
return numpy.  Priors follow the reference: data columns get
``data_prior``, measurement-error columns ``meas_prior``.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from scipy import sparse

from ..circuits.storage_sim import build_storage_simulation
from ..codes.io import read_quantum_code
from ..utils.device import DeviceLike, resolve_device
from ..utils.observability import span
from . import memory
from .bposd import BPOSDDecoder
from .dem import detector_error_model
from .flip import SmallSetFlipDecoder
from .parity import mod2_matmul, spacetime_syndromes
from .relay_bp import RelayBPDecoder
from .select import (make_bp_decoder, make_spacetime_bp_decoder, qc_kwargs_for_code,
                     qc_kwargs_single_shot)
from .sliding_window import SlidingWindowDecoder
from .spacetime import DetectorSpacetimeCode, SpacetimeCode, SpacetimeCodeSingleShot

__all__ = ["BPOSDCorrect", "BPOSDCorrectSingleShot", "BPOSDHybridCorrect", "BPDetectorCorrect",
           "RelayBPCorrect", "SSFCorrect", "SlidingWindowCorrect", "run_simulation",
           "DECODER_MODES", "add_bposd_args", "unpack_bposd_args", "load_code",
           "spacetime_prior", "relay_kwargs", "check_options"]


def spacetime_prior(spacetime, data_prior: float, meas_prior: float) -> np.ndarray:
    """Per-column error probabilities of a ``SpacetimeCode``: data columns
    ``data_prior``, measurement-error columns ``meas_prior``."""
    prior = np.zeros(spacetime.spacetime_check_matrix.shape[1])
    prior[: spacetime._datablock_size] = data_prior
    prior[spacetime._datablock_size:] = meas_prior
    return prior


_BP_KEYS = ("max_iter", "bp_method", "ms_scaling_factor")
_OSD_KEYS = ("osd_method", "osd_order")
RELAY_KEYS = ("relay_legs", "relay_iters_per_leg", "relay_seed")


def check_options(driver: str, bp_osd_options: Dict, extra: Iterable[str] = ()) -> None:
    """Refuse options outside the BP and OSD keys and ``extra``."""
    unknown = set(bp_osd_options) - set(_BP_KEYS) - set(_OSD_KEYS) - set(extra)
    if unknown:
        raise ValueError(f"{driver}: unsupported options {sorted(unknown)}")


class _MemoryCorrect:
    """A memory mode's driver: the mode's algebra (:mod:`.memory`) over the
    driver's ``_stages`` on ``device``, where ``_H`` holds the sector's checks."""

    def __init__(self, code, basis: str, device: DeviceLike, options: Dict, mode: str,
                 extra=()):
        check_options(type(self).__name__, options, extra)
        self._dev = resolve_device(device)
        self._checks = code.checks.x if basis == "x" else code.checks.z
        self._H = torch.as_tensor(self._checks.toarray(), dtype=torch.float32, device=self._dev)
        self._mode = memory.MODES[mode]

    def readout_correction_batch(self, history, readout) -> np.ndarray:
        """history (S, rounds, r), readout (S, n), numpy or tensors -> the
        final-round correction (S, n) int64, copied to the host once."""
        with span("redecode"):
            as_t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=self._dev)  # noqa: E731
            correction, _ok = self._mode(self._H, as_t(history), as_t(readout), *self._stages)
            return correction.to(torch.int64).cpu().numpy()


class BPOSDCorrect(_MemoryCorrect):
    """BP+OSD on the full spacetime matrix: BP on ``device`` (kernel chosen
    by :func:`.select.make_spacetime_bp_decoder`), OSD on K8 where it takes
    the shape, else on the host."""

    def __init__(self, code, rounds: int, bp_osd_options: Dict,
                 priors: Tuple[float, float], basis: str = "z", device: DeviceLike = "cuda"):
        super().__init__(code, basis, device, bp_osd_options, "bposd")
        data_prior, meas_prior = priors
        self._spacetime_code = SpacetimeCode(self._checks, rounds)
        bp = make_spacetime_bp_decoder(
            self._checks, rounds, device=self._dev,
            channel_probs=spacetime_prior(self._spacetime_code, data_prior, meas_prior),
            **{k: v for k, v in bp_osd_options.items() if k in _BP_KEYS},
        )
        self._bpd = BPOSDDecoder(bp, self._spacetime_code.spacetime_check_matrix.tocsr(),
                                 **{k: v for k, v in bp_osd_options.items() if k in _OSD_KEYS})
        self._stages = (self._bpd.decode_tensors,)


class BPOSDCorrectSingleShot(_MemoryCorrect):
    """Per-round (H|I) BP+OSD with an accumulated correction, then BP+OSD of
    the final round on H (JAX ``drivers.py:83-120``).  The flat BP of both
    decoders is chosen by :func:`.select.make_bp_decoder`: on a CUDA device
    kernel K1 with its exit per shot block armed (BP+OSD asks the exit)."""

    def __init__(self, code, rounds: int, bp_osd_options: Dict,
                 priors: Tuple[float, float], basis: str = "z", device: DeviceLike = "cuda"):
        super().__init__(code, basis, device, bp_osd_options, "bposd_single_shot")
        data_prior, meas_prior = priors
        self._spacetime_code = SpacetimeCodeSingleShot(self._checks)
        self._bpd_single_shot = BPOSDDecoder.from_check_matrix(
            self._spacetime_code.spacetime_check_matrix,
            channel_probs=spacetime_prior(self._spacetime_code, data_prior, meas_prior),
            **qc_kwargs_single_shot(code, sector=basis), **bp_osd_options, device=self._dev)
        self._bpd_final_round = BPOSDDecoder.from_check_matrix(
            self._checks, error_rate=data_prior, **qc_kwargs_for_code(code, sector=basis),
            **bp_osd_options, device=self._dev)
        self._stages = (self._bpd_single_shot.decode_tensors,
                        self._bpd_final_round.decode_tensors)


class BPOSDHybridCorrect(_MemoryCorrect):
    """Plain spacetime BP (kernel chosen by
    :func:`.select.make_spacetime_bp_decoder`), then BP+OSD of the final
    round on H (JAX ``drivers.py:124-158``; flat BP chosen by
    :func:`.select.make_bp_decoder`)."""

    def __init__(self, code, rounds: int, bp_osd_options: Dict,
                 priors: Tuple[float, float], basis: str = "z", device: DeviceLike = "cuda"):
        super().__init__(code, basis, device, bp_osd_options, "bposd_hybrid")
        data_prior, meas_prior = priors
        self._spacetime_code = SpacetimeCode(self._checks, rounds)
        self._bpd = make_spacetime_bp_decoder(
            self._checks, rounds, device=self._dev,
            channel_probs=spacetime_prior(self._spacetime_code, data_prior, meas_prior),
            **{k: v for k, v in bp_osd_options.items() if k in _BP_KEYS})
        self._bpd_final_round = BPOSDDecoder.from_check_matrix(
            self._checks, error_rate=data_prior, **qc_kwargs_for_code(code, sector=basis),
            **bp_osd_options, device=self._dev)
        self._stages = (self._spacetime_bp, self._bpd_final_round.decode_tensors)

    def _spacetime_bp(self, syndromes: torch.Tensor):
        with span("redecode.bp"):
            hard, _post, conv, _iters = self._bpd.decode_tensors(syndromes)
        return hard, conv


class SlidingWindowCorrect:
    """Streaming overlapping-window BP+OSD (:class:`.sliding_window.
    SlidingWindowDecoder`; JAX ``drivers.py:161-181``).  ``window_size`` /
    ``window_commit`` keys extend the bposd option dict."""

    def __init__(self, code, rounds: int, bp_osd_options: Dict,
                 priors: Tuple[float, float], basis: str = "z", device: DeviceLike = "cuda"):
        check_options("SlidingWindowCorrect", bp_osd_options, ("window_size", "window_commit"))
        data_prior, meas_prior = priors
        opts = dict(bp_osd_options)
        window = int(opts.pop("window_size", 4))
        commit = opts.pop("window_commit", None)
        self._dec = SlidingWindowDecoder(
            code.checks.x if basis == "x" else code.checks.z, data_prior, meas_prior,
            window=window, commit=None if commit is None else int(commit), bp_options=opts,
            device=device)

    def readout_correction_batch(self, history: np.ndarray, readout: np.ndarray) -> np.ndarray:
        """history (S, rounds, r), readout (S, n) -> final-round correction (S, n)."""
        return self._dec.decode_batch(history, readout)


class SSFCorrect(_MemoryCorrect):
    """Single-shot small-set-flip (JAX ``drivers.py:184-235``): per-round
    (H|I) SSF with an accumulated correction, then a clean final-round SSF,
    in the round-loop structure of :class:`BPOSDCorrectSingleShot`.  The
    per-round flip search runs over the zero-padded opposite-sector
    stabilizer generators plus a weight-1 generator for each
    measurement-error column.  ``ssf_max_iter`` extends the option dict (0
    = one flip per spacetime column); the BP and OSD options are unused."""

    def __init__(self, code, rounds: int, bp_osd_options: Dict,
                 priors: Tuple[float, float], basis: str = "z", device: DeviceLike = "cuda"):
        super().__init__(code, basis, device, bp_osd_options, "bposd_single_shot",
                         ("ssf_max_iter",))
        self._spacetime_code = SpacetimeCodeSingleShot(self._checks)
        max_iter = int(bp_osd_options.get("ssf_max_iter", 0) or 0)
        r, n = self._checks.shape
        # flip generators come from the OPPOSITE sector's stabilizers
        gx = code.checks.z if basis == "x" else code.checks.x
        gen_data = sparse.hstack([gx, sparse.csr_matrix((gx.shape[0], r), dtype=np.uint8)])
        gen_meas = sparse.hstack([sparse.csr_matrix((r, n), dtype=np.uint8),
                                  sparse.identity(r, dtype=np.uint8)])
        generators = sparse.vstack([gen_data, gen_meas]).tocsr()
        self._dec_ss = SmallSetFlipDecoder.from_css(
            self._spacetime_code.spacetime_check_matrix, generators, max_iter=max_iter,
            device=self._dev)
        self._dec_final = SmallSetFlipDecoder.from_css(self._checks, gx, max_iter=max_iter,
                                                       device=self._dev)
        self._stages = (lambda s: self._dec_ss.decode_tensors(s)[:2],
                        lambda s: self._dec_final.decode_tensors(s)[:2])


def relay_kwargs(opts: Dict, default_alpha: float) -> Dict:
    """:class:`.relay_bp.RelayBPDecoder`'s settings from an option dict
    (``relay_legs``, default 8; ``relay_iters_per_leg``, 30; ``relay_seed``,
    0; ``bp_method``, "ms"; ``ms_scaling_factor``, ``default_alpha`` where it
    is 0 or missing)."""
    return {"method": opts.get("bp_method", "ms"),
            "ms_scaling_factor": float(opts.get("ms_scaling_factor", default_alpha)
                                       or default_alpha),
            "num_legs": int(opts.get("relay_legs", 8)),
            "iters_per_leg": int(opts.get("relay_iters_per_leg", 30)),
            "seed": int(opts.get("relay_seed", 0))}


def _relay_decoder(H, channel_probs, opts: Dict, default_alpha: float, device):
    """The relay BP ensemble of ``opts`` (:func:`relay_kwargs`)."""
    return RelayBPDecoder.from_check_matrix(H, channel_probs=channel_probs, device=device,
                                            **relay_kwargs(opts, default_alpha))


class RelayBPCorrect:
    """Relay BP ensemble on the full spacetime matrix, no OSD (JAX
    ``drivers.py:238-269``; arXiv:2507.00254).  ``relay_legs`` (8),
    ``relay_iters_per_leg`` (30) and ``relay_seed`` (0) extend the option
    dict; ``max_iter`` and the OSD options are unused."""

    def __init__(self, code, rounds: int, bp_osd_options: Dict,
                 priors: Tuple[float, float], basis: str = "z", device: DeviceLike = "cuda"):
        check_options("RelayBPCorrect", bp_osd_options, RELAY_KEYS)
        data_prior, meas_prior = priors
        self._checks = code.checks.x if basis == "x" else code.checks.z
        self._spacetime_code = SpacetimeCode(self._checks, rounds)
        self._bpd = _relay_decoder(
            self._spacetime_code.spacetime_check_matrix,
            spacetime_prior(self._spacetime_code, data_prior, meas_prior), bp_osd_options, 1.0,
            resolve_device(device))

    def readout_correction_batch(self, history: np.ndarray, readout: np.ndarray) -> np.ndarray:
        """history (S, rounds, r), readout (S, n) -> final-round correction (S, n)."""
        syndromes = spacetime_syndromes(self._spacetime_code, history, readout)
        return self._spacetime_code.final_correction(self._bpd.decode_batch(syndromes)[0])


class BPDetectorCorrect:
    """BP on the detector error model's fault matrix (JAX
    ``drivers.py:272-339``): flat BP chosen by
    :func:`.select.make_bp_decoder` (on a card kernel K1 for detector models,
    route "wide" where a fault check has more than 32 slots); with
    ``relay_legs`` > 0 the relay ensemble instead (α 0.625 unless set); with
    ``detector_osd`` OSD (``osd_method`` default "osd0", ``osd_order`` 0) of
    the shots BP left unconverged, on the fault matrix."""

    def __init__(self, dem, bp_osd_options: Dict, device: DeviceLike = "cuda"):
        check_options("BPDetectorCorrect", bp_osd_options, RELAY_KEYS + ("detector_osd",))
        dev = resolve_device(device)
        self._dsc = DetectorSpacetimeCode(dem)
        opts = dict(bp_osd_options)
        use_osd = bool(opts.pop("detector_osd", False))
        H = self._dsc.fault_check_matrix
        if int(opts.get("relay_legs", 0) or 0) > 0:
            bp = _relay_decoder(H, self._dsc.fault_priors, opts, 0.625, dev)
        else:
            # fault matrices grow with rounds: the formulation selection routes them
            bp = make_bp_decoder(H, channel_probs=self._dsc.fault_priors, device=dev,
                                 **{k: v for k, v in opts.items() if k in _BP_KEYS})
        self._bpd = (BPOSDDecoder(bp=bp, H=sparse.csr_matrix(H),
                                  osd_method=opts.get("osd_method", "osd0"),
                                  osd_order=opts.get("osd_order", 0))
                     if use_osd else bp)
        self._use_osd = use_osd
        self._fault_map_T = self._dsc.fault_map.T.toarray()

    def readout_correction_batch(self, detector_batch: np.ndarray) -> np.ndarray:
        """detector_batch (S, D + L) with observables appended -> corrected
        observable bits (S, L)."""
        D = self._dsc.fault_check_matrix.shape[0]
        syndrome = detector_batch[:, :D]
        logicals = detector_batch[:, D:].astype(np.int64)
        out = self._bpd.decode_batch(syndrome)
        return (logicals + mod2_matmul(out if self._use_osd else out[0], self._fault_map_T)) % 2


DECODER_MODES = {"bposd": BPOSDCorrect, "bposd_single_shot": BPOSDCorrectSingleShot,
                 "bposd_hybrid": BPOSDHybridCorrect, "bpd_detector": BPDetectorCorrect,
                 "relay_bp": RelayBPCorrect, "ssf_single_shot": SSFCorrect,
                 "sliding_window": SlidingWindowCorrect}


def _steps(H) -> int:
    """Circuit depth hook argument: the larger of H's max column and row weight."""
    return max(int(H.sum(axis=0).max()), int(H.sum(axis=1).max()))


def run_simulation(samples: int, code, meas_prior, data_prior, noise_model, noise_model_args,
                   bp_osd_options: Dict, rounds: int, decoder_mode: str,
                   seed: Optional[int] = None, use_device_sampler: Optional[bool] = None,
                   use_x_logicals: Optional[bool] = None, device: DeviceLike = "cuda"):
    """Build the storage circuit, sample, decode every shot; returns the
    per-shot logical-failure booleans (a list, as JAX's ``run_simulation``).

    ``meas_prior`` / ``data_prior`` are callables ``(x_steps, z_steps) ->
    float``.  ``use_device_sampler`` (default True) draws the records with
    :class:`..sampler.device.DeviceSampler` on ``device`` from a
    ``torch.Generator`` seeded ``seed or 0``; False draws them on the host
    with the port's ``FrameSampler(circuit, seed=seed)``, which gives the
    JAX package's records for the same seed.  ``use_x_logicals`` runs the
    X-basis memory experiment (``checks.x`` / ``logicals.x`` on the X-check
    block of the record).  An unknown ``decoder_mode`` raises
    ``RuntimeError``.
    """
    dev = resolve_device(device)
    use_x_logicals = bool(use_x_logicals)
    basis = "x" if use_x_logicals else "z"
    checks, logicals = code.checks, code.logicals
    x_steps, z_steps = _steps(checks.x), _steps(checks.z)
    storage_sim = build_storage_simulation(
        rounds, noise_model(**noise_model_args), code, use_x_logicals=use_x_logicals)
    priors = (data_prior(x_steps, z_steps), meas_prior(x_steps, z_steps))

    detectors = decoder_mode == "bpd_detector"
    if decoder_mode not in DECODER_MODES:
        raise RuntimeError("Unknown decoder operation mode")
    if detectors:
        decoder = BPDetectorCorrect(detector_error_model(storage_sim.circuit), bp_osd_options,
                                    device=dev)
    else:
        decoder = DECODER_MODES[decoder_mode](code, rounds, bp_osd_options, priors, basis=basis,
                                              device=dev)

    # ---- sample ----
    if use_device_sampler is None or use_device_sampler:
        from ..sampler.device import DeviceSampler

        sampler = DeviceSampler(storage_sim.circuit, shots=samples, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed if seed is not None else 0)
        batch = (sampler.sample_detectors(gen, append_observables=True) if detectors
                 else sampler.sample(gen)).cpu().numpy()
    else:
        from ..sampler.reference import FrameSampler

        fs = FrameSampler(storage_sim.circuit, seed=seed)
        batch = (fs.sample_detectors(samples, append_observables=True) if detectors
                 else fs.sample(samples))

    # ---- decode (batched) ----
    if detectors:
        corrected = decoder.readout_correction_batch(batch)
        return list(np.any(corrected != 0, axis=1))

    x_count, z_count = checks.x.shape[0], checks.z.shape[0]
    mpr = x_count + z_count
    S = batch.shape[0]
    # record layout per round: [x_checks..., z_checks...]; decode the block
    # of the memory basis (an X-basis readout is measured by the X checks)
    blk_off = 0 if use_x_logicals else x_count
    blk_len = x_count if use_x_logicals else z_count
    if rounds > 0:
        history = np.stack(
            [batch[:, r * mpr + blk_off: r * mpr + blk_off + blk_len] for r in range(rounds)],
            axis=1).astype(np.int64)
    else:
        history = np.zeros((S, 0, blk_len), dtype=np.int64)
    readout = batch[:, mpr * rounds: mpr * rounds + code.num_qubits].astype(np.int64)

    correction = decoder.readout_correction_batch(history, readout)
    corrected_readout = (readout + correction) % 2
    final_logicals = logicals.x if use_x_logicals else logicals.z
    logical_flips = mod2_matmul(corrected_readout, final_logicals.T)
    return list(np.any(logical_flips != 0, axis=1))


def add_bposd_args(parser):
    """BP+OSD CLI arguments (same surface as the JAX package)."""
    parser.add_argument(
        "--bposd_max_iter", type=lambda x: int(x) if x is not None else None,
        help="BP iteration cap (defaults to the code's qubit count)", default=None)
    parser.add_argument(
        "--bposd_bp_method", choices=["ps", "ms", "msl"],
        help="BP update rule: product-sum, min-sum, or log-domain min-sum", default="ps")
    parser.add_argument(
        "--bposd_ms_scaling_factor", type=float,
        help="min-sum scaling alpha; 0 selects the adaptive 1-2^-t schedule", default=0)
    parser.add_argument(
        "--bposd_osd_method", choices=["osd_e", "osd_cs", "osd0"],
        help="OSD post-processing variant", default="osd_cs")
    parser.add_argument("--bposd_osd_order", type=int,
                        help="OSD combination-sweep / exhaustion depth", default=7)


def unpack_bposd_args(parsed_args, code) -> Dict:
    """CLI arguments -> decoder options dict."""
    return {
        "max_iter": parsed_args.bposd_max_iter
        if parsed_args.bposd_max_iter is not None else code.checks.num_qubits,
        "bp_method": parsed_args.bposd_bp_method,
        "ms_scaling_factor": parsed_args.bposd_ms_scaling_factor,
        "osd_method": parsed_args.bposd_osd_method,
        "osd_order": parsed_args.bposd_osd_order,
    }


def load_code(args):
    """Load and validate a code file."""
    with args.code.open() as code_file:
        return read_quantum_code(code_file, validate_stabilizer_code=True)
