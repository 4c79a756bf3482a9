"""Physical-error-rate sweep driver of the port.

Counterpart of ``exp_ldpc_tpu/experiments/p_sweep.py``: the same CLI
surface, the same JSONL checkpoint, and a CSV with the same columns in the
same order as the JAX ``DataFrame.to_csv`` (written with :mod:`csv`; the
port does not depend on pandas).

Without ``pipeline`` (the CLI without ``--pipeline``) point i runs
:func:`..decoders.drivers.run_simulation` with seed ``seed + i``, in any of
the seven decoder modes, sampling on the device or, with
``use_device_sampler=False`` (``--cpu_sampler``), with the host
``FrameSampler``.  With ``pipeline`` each point runs through
:class:`..parallel.pipeline.StorageDecodePipeline` (the three BP+OSD modes
and ``relay_bp``, sampled on the device); batch j of point i draws on rank k from a
``torch.Generator`` seeded by :func:`batch_seed` from (seed, i, j, k).  With
``mesh_devices`` N > 1 the sweep runs in N processes, one per device,
joined by :func:`..parallel.mesh.init_distributed`: each rank calls
:func:`p_sweep`, the counts are summed over the data axis, and rank 0 alone
writes the checkpoint and the CSV.  The CLI starts the N processes itself
(``--mesh_devices N``).
"""
from __future__ import annotations

import csv
import json
import subprocess
import sys
import time
from argparse import ArgumentParser
from datetime import datetime
from pathlib import Path
from typing import IO, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..decoders.drivers import add_bposd_args, load_code, run_simulation, unpack_bposd_args
from ..parallel.mesh import DATA_AXIS, Mesh, free_port, init_distributed, make_mesh
from ..utils.device import DeviceLike, resolve_device
from ..utils.observability import get_logger, span

__all__ = ["p_sweep", "p_sweep_main", "parse_sweep_spec", "write_csv", "batch_seed",
           "cli_main"]

_log = get_logger("p_sweep")


def _load_checkpoint(path: Path) -> List[dict]:
    """Completed sweep-point records from a JSONL checkpoint (resume support)."""
    records = []
    if path.exists():
        with path.open() as f:
            for line in f:
                line = line.strip()
                if line:
                    records.append(json.loads(line))
    return records


def batch_seed(seed: Optional[int], point: int, batch: int, rank: int = 0) -> int:
    """Deterministic 63-bit generator seed for batch ``batch`` of sweep
    point ``point`` on data rank ``rank``: the SeedSequence of (seed, point,
    batch), with the rank appended for ranks > 0, so rank 0 draws what a
    one-device sweep draws."""
    entropy = [0 if seed is None else int(seed), point, batch] + ([rank] if rank else [])
    ss = np.random.SeedSequence(entropy)
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


class _PipelineSweeper:
    """One pipeline for the whole p grid: noise probabilities and priors
    rebind between points, the tables and kernels stay."""

    def __init__(self, code, rounds, noise_model, noise_model_args, meas_prior, data_prior,
                 bp_osd_options, shots_per_device: int, device: torch.device,
                 use_x_logicals: bool = False, mode: str = "bposd",
                 mesh: Optional[Mesh] = None):
        checks = code.checks
        self._x_steps = max(int(checks.x.sum(axis=0).max()), int(checks.x.sum(axis=1).max()))
        self._z_steps = max(int(checks.z.sum(axis=0).max()), int(checks.z.sum(axis=1).max()))
        self.code = code
        self.rounds = rounds
        self.noise_model = noise_model
        self.noise_model_args = noise_model_args
        self.meas_prior = meas_prior
        self.data_prior = data_prior
        self.options = dict(bp_osd_options)
        self.shots_per_device = shots_per_device
        self.device = device
        self.use_x_logicals = use_x_logicals
        self.mode = mode
        self.mesh = mesh
        self.pipe = None

    def run_point(self, p_ph: float, samples: int, seed: Optional[int], point: int):
        from ..parallel.pipeline import StorageDecodePipeline

        with span("point"):
            noise = self.noise_model(**self.noise_model_args(p_ph))
            data_p = self.data_prior(p_ph, self._x_steps, self._z_steps)
            meas_p = self.meas_prior(p_ph, self._x_steps, self._z_steps)
            if self.pipe is None:
                opts = self.options
                self.pipe = StorageDecodePipeline(
                    code=self.code, rounds=self.rounds, noise_model=noise,
                    data_prior=data_p, meas_prior=meas_p,
                    shots_per_device=self.shots_per_device,
                    max_iter=int(opts.get("max_iter", 40)),
                    bp_method=opts.get("bp_method", "ps"),
                    ms_scaling_factor=float(opts.get("ms_scaling_factor", 0.0)),
                    # relay_bp decodes every shot on the device: no host stage
                    osd_fallback_cap=0 if self.mode == "relay_bp" else self.shots_per_device,
                    osd_options=opts,
                    use_x_logicals=self.use_x_logicals, mode=self.mode,
                    # two-tier decode (mode "bposd" only, as in JAX): a short stage-1
                    # budget, then a fixed-size redecode of the unconverged shots
                    tier1_iters=(int(opts.get("tier1_iters", 0) or 0)
                                 if self.mode == "bposd" else 0),
                    mesh=self.mesh, device=self.device)
            else:
                self.pipe.rebind_noise(noise, data_p, meas_p)
            n_data, rank = (1, 0) if self.mesh is None else (self.mesh.shape[DATA_AXIS],
                                                            self.mesh.data_index)
            n_batches = max(1, -(-samples // (self.shots_per_device * n_data)))
            failures = total = osd = 0
            for j in range(n_batches):
                gen = torch.Generator(device=self.pipe.device)
                gen.manual_seed(batch_seed(seed, point, j, rank))
                # the third count: shots OSD decoded, or shots the relay left unsolved
                f, s, o = (self.pipe.run(gen) if self.mode == "relay_bp"
                           else self.pipe.run_bposd(gen))
                failures, total, osd = failures + f, total + s, osd + o
            return failures, total, osd


def p_sweep(samples, p_values, noise_model, noise_model_args, meas_prior, data_prior,
            seed=None, use_device_sampler=None, checkpoint: Optional[Path] = None,
            pipeline: Optional[dict] = None, device: DeviceLike = "cuda", **kwargs) -> List[dict]:
    """Sweep physical error rates; returns the list of point records (the
    rows of the JAX package's DataFrame, in order).

    Without ``pipeline`` each point is one :func:`run_simulation` call
    (``decoder_mode`` any of its seven modes) with seed ``seed + i`` and the
    given ``use_device_sampler``.  ``pipeline`` (dict of
    ``mesh_devices``/``shots_per_device``) runs the ``bposd``,
    ``bposd_single_shot``, ``bposd_hybrid`` and ``relay_bp`` modes through
    the device pipeline, which samples on the device: with ``use_device_sampler=False``
    it raises (the host sampler runs on the host path only).  With
    ``mesh_devices`` N > 1, every rank of a joined world of N processes
    calls this function with the same arguments (``device`` "cuda" gives
    rank r the card r); all ranks return the same records.  With
    ``checkpoint`` set, completed points are appended to a JSONL file (by
    rank 0) and a restarted sweep skips them.
    """
    sweeper, writer = None, True
    if pipeline is not None:
        if use_device_sampler is False:
            raise ValueError("the pipeline samples on the device: drop --pipeline to sample "
                             "with the host oracle (--cpu_sampler, use_device_sampler=False)")
        mode = kwargs.get("decoder_mode", "bposd")
        if mode not in ("bposd", "bposd_single_shot", "bposd_hybrid", "relay_bp"):
            raise ValueError(
                "the fused pipeline implements the bposd/bposd_single_shot/"
                "bposd_hybrid/relay_bp modes; drop --pipeline for other decoder modes")
        n_dev = int(pipeline.get("mesh_devices", 1))
        mesh = make_mesh(n_dev, device=device) if n_dev > 1 else None
        writer = mesh is None or mesh.rank == 0
        sweeper = _PipelineSweeper(
            code=kwargs["code"], rounds=kwargs.get("rounds", 1), noise_model=noise_model,
            noise_model_args=noise_model_args, meas_prior=meas_prior, data_prior=data_prior,
            bp_osd_options=kwargs["bp_osd_options"],
            shots_per_device=int(pipeline.get("shots_per_device", 4096)),
            device=resolve_device(device),
            use_x_logicals=bool(kwargs.get("use_x_logicals", False)), mode=mode, mesh=mesh)
    data: List[dict] = []
    done_p = set()
    if checkpoint is not None:
        checkpoint = Path(checkpoint)
        data = _load_checkpoint(checkpoint)
        done_p = {round(float(rec["p_ph"]), 12) for rec in data}
        if data:
            _log.info("resuming sweep: %d completed points in %s", len(data), checkpoint)

    for i, p_ph in enumerate(p_values):
        if round(float(p_ph), 12) in done_p:
            continue
        time_start = datetime.now()
        if sweeper is not None:
            failures, total, osd = sweeper.run_point(p_ph, samples, seed, i)
        else:
            logical_values = run_simulation(
                samples, noise_model=noise_model, noise_model_args=noise_model_args(p_ph),
                meas_prior=lambda xs, zs, p=p_ph: meas_prior(p, xs, zs),
                data_prior=lambda xs, zs, p=p_ph: data_prior(p, xs, zs),
                seed=(seed + i if seed is not None else None),
                use_device_sampler=use_device_sampler, device=device, **kwargs)
            failures, total = int(sum(logical_values)), len(logical_values)
        runtime = (datetime.now() - time_start).total_seconds()
        point = {"p_ph": p_ph, "failures": failures, "samples": total, "walltime": runtime,
                 **kwargs, **(kwargs["bp_osd_options"])}
        del point["code"]
        del point["bp_osd_options"]
        if sweeper is None:
            _log.info("p=%g: %d/%d failures in %.1fs", p_ph, failures, total, runtime)
        elif writer:
            # the record's args are the point's five numbers, whatever the mode
            msg = ("p=%g: %d/%d failures (%d unsolved) in %.1fs" if sweeper.mode == "relay_bp"
                   else "p=%g: %d/%d failures (%d OSD-decoded) in %.1fs")
            _log.info(msg, p_ph, failures, total, osd, runtime)
        data.append(point)
        if checkpoint is not None and writer:
            def _jsonable(v):
                if hasattr(v, "item"):  # numpy scalars
                    v = v.item()
                return v if isinstance(v, (int, float, str, bool, type(None))) else repr(v)
            with checkpoint.open("a") as f:
                json.dump({k: _jsonable(v) for k, v in point.items()}, f)
                f.write("\n")
    return data


def _csv_value(v):
    if v is None:
        return ""
    if hasattr(v, "item"):  # numpy scalars
        v = v.item()
    return repr(v) if isinstance(v, float) else v


def write_csv(records: List[dict], out: IO[str]) -> None:
    """Records -> CSV laid out as ``pandas.DataFrame.from_records(records)
    .to_csv(out)``: an unnamed index column, then the union of the records'
    keys in first-seen order."""
    columns: List[str] = []
    for rec in records:
        columns.extend(k for k in rec if k not in columns)
    w = csv.writer(out, lineterminator="\n")
    w.writerow([""] + columns)
    for i, rec in enumerate(records):
        w.writerow([i] + [_csv_value(rec.get(k)) for k in columns])


def parse_sweep_spec(x: str) -> Tuple[float, float, int]:
    """Parse a sweep-grid spec like ``(1e-3, 0.05, 6)``: float bounds
    ``lower <= upper`` and a positive integer point count."""
    body = x.strip()
    if not (body.startswith("(") and body.endswith(")")):
        raise RuntimeError(f"sweep spec must be a parenthesized triple, got {x!r}")
    parts = body[1:-1].split(",")
    if len(parts) != 3:
        raise RuntimeError(
            f"sweep spec needs exactly 3 comma-separated fields "
            f"(lower, upper, points), got {len(parts)} in {x!r}")
    try:
        lower, upper, points = float(parts[0]), float(parts[1]), int(parts[2])
    except ValueError as exc:
        raise RuntimeError(f"sweep spec {x!r}: {exc}") from exc
    if points <= 0:
        raise RuntimeError(f"sweep spec {x!r}: point count must be positive")
    if lower > upper:
        raise RuntimeError(f"sweep spec {x!r}: lower bound exceeds upper bound")
    return (lower, upper, points)


def p_sweep_main(noise_model_args, noise_model, meas_prior, data_prior, argv=None):
    """argparse main; writes the CSV to stdout."""
    parser = ArgumentParser(
        description="Perform a batched sweep in the physical error rate for the given "
        "quantum code under BP+OSD, on a PyTorch device")
    parser.add_argument("code", type=Path)
    parser.add_argument("--samples", type=int, help="Monte-Carlo shots per sweep point")
    parser.add_argument("--p_sweep", type=parse_sweep_spec,
                        help="sweep grid as (lower, upper, points)")
    parser.add_argument("--rounds", type=int, help="syndrome-extraction rounds per shot",
                        default=1)
    parser.add_argument(
        "--decoder_mode",
        choices=["bposd", "bposd_single_shot", "bposd_hybrid", "bpd_detector",
                 "relay_bp", "sliding_window", "ssf_single_shot"],
        help="Operate decoder in BP+OSD, BP+OSD (single shot), hybrid BP + (BP+OSD), "
        "detector-model BP, the OSD-free relay-BP ensemble, streaming sliding-window "
        "BP+OSD, or single-shot small-set-flip", default="bposd")
    parser.add_argument("--linspace", type=bool,
                        help="linearly spaced sweep points (default: geometric spacing)",
                        default=False)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--cpu_sampler", action="store_true",
                        help="Use the CPU oracle sampler instead of the device sampler")
    parser.add_argument("--x_basis", action="store_true",
                        help="Run the X-basis memory experiment instead of the Z basis")
    parser.add_argument("--checkpoint", type=Path, default=None,
                        help="JSONL file to stream completed sweep points to; re-running "
                        "with the same file resumes after the last completed point")
    parser.add_argument("--pipeline", action="store_true",
                        help="Run each sweep point through the on-device sample+decode "
                        "pipeline (bposd, bposd_single_shot, bposd_hybrid and relay_bp modes)")
    parser.add_argument("--mesh_devices", type=int, default=1,
                        help="Shard pipeline shots over this many devices")
    parser.add_argument("--shots_per_device", type=int, default=4096,
                        help="Monte-Carlo sub-batch size per device per pipeline step")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the plain versions of the kernels")
    parser.add_argument("--backend", choices=["gloo", "nccl"], default=None,
                        help="torch.distributed backend with --mesh_devices > 1 (default: "
                        "nccl on cuda, gloo on cpu)")
    parser.add_argument("--rank", type=int, default=None,
                        help="this process's rank with --mesh_devices > 1 (set by the launcher)")
    parser.add_argument("--init_method", type=str, default=None,
                        help="tcp://host:port of the world with --rank (set by the launcher)")
    add_bposd_args(parser)

    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    rank, joined = 0, False
    if args.pipeline and args.mesh_devices > 1:
        if args.rank is None or args.init_method is None:
            raise SystemExit("--mesh_devices > 1 runs one process per device: start it through "
                             "qldpc-p-sweep-torch, or pass --rank and --init_method to each")
        backend = args.backend or ("gloo" if args.device == "cpu" else "nccl")
        joined = not dist.is_initialized()
        rank = init_distributed(args.init_method, args.mesh_devices, args.rank, backend)
    try:
        _sweep_cli(args, rank, noise_model_args, noise_model, meas_prior, data_prior)
    finally:
        if joined:
            dist.destroy_process_group()


def _sweep_cli(args, rank, noise_model_args, noise_model, meas_prior, data_prior):
    code = load_code(args)
    bp_osd_options = unpack_bposd_args(args, code)
    sweep = np.linspace(*args.p_sweep) if args.linspace else np.geomspace(*args.p_sweep)
    result = p_sweep(
        samples=args.samples, code=code, rounds=args.rounds, noise_model=noise_model,
        noise_model_args=noise_model_args, meas_prior=meas_prior, data_prior=data_prior,
        p_values=sweep, decoder_mode=args.decoder_mode, bp_osd_options=bp_osd_options,
        use_x_logicals=args.x_basis, seed=args.seed,
        use_device_sampler=not args.cpu_sampler, checkpoint=args.checkpoint,
        pipeline=({"mesh_devices": args.mesh_devices,
                   "shots_per_device": args.shots_per_device} if args.pipeline else None),
        device=args.device,
    )
    if rank == 0:
        write_csv(result, sys.stdout)


def _launch_ranks(argv: List[str], n: int) -> int:
    """Run this module's CLI in ``n`` processes joined over a free localhost
    port, ranks 0..n-1; returns the first nonzero exit code (the other
    ranks are then stopped), else 0.  Rank 0 writes the CSV to stdout."""
    init = f"tcp://localhost:{free_port()}"
    cmd = [sys.executable, "-m", "exp_ldpc_tpu_torch.experiments.p_sweep"]
    procs = [subprocess.Popen(cmd + argv + ["--rank", str(k), "--init_method", init])
             for k in range(n)]
    rc = 0
    try:
        while rc == 0 and any(p.poll() is None for p in procs):
            rc = next((p.returncode for p in procs if p.returncode), 0)
            time.sleep(0.2)
        rc = rc or next((p.returncode for p in procs if p.returncode), 0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return rc


def cli_main(argv=None):
    """Console entry point: pheno noise with the reference's 2/3*p prior.
    With ``--pipeline --mesh_devices N`` (N > 1) and no ``--rank`` it
    starts the N rank processes itself."""
    from ..circuits.noise import depolarizing_noise

    argv = list(sys.argv[1:] if argv is None else argv)
    probe = ArgumentParser(add_help=False)
    probe.add_argument("--pipeline", action="store_true")
    probe.add_argument("--mesh_devices", type=int, default=1)
    probe.add_argument("--rank", type=int, default=None)
    known, _ = probe.parse_known_args(argv)
    if known.pipeline and known.mesh_devices > 1 and known.rank is None:
        rc = _launch_ranks(argv, known.mesh_devices)
        if rc:
            raise SystemExit(rc)
        return
    p_sweep_main(
        noise_model_args=lambda p: {"p": p, "pm": p},
        noise_model=depolarizing_noise,
        meas_prior=lambda p, x_steps, z_steps: 2 / 3 * p,
        data_prior=lambda p, x_steps, z_steps: 2 / 3 * p,
        argv=argv,
    )


if __name__ == "__main__":
    cli_main()
