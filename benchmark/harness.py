"""One run of one cell of ``BENCHMARK.json`` on one card.

Set-up (everything from the process's start to the window: imports, the
CUDA context, loading or building the kernels and the native OSD library,
the code and the pipeline, one warm-up batch of the cell's shapes) is
``setup_s``.  The window then runs whole units of the cell's entry (a
sweep point, or a batch) and ends at the first unit boundary after
``--seconds``; ``shots_per_s`` is every shot decoded over the window's wall
time.  With ``--trace 1`` the first ``trace_units`` units run under
``torch.profiler`` with a span around each layer, and the run reports the
per-layer metrics instead.  Afterwards the program is released and the
kept batches are checked against the plain reference (:mod:`.check`).

The last line of standard output is the result, one JSON object; the
numbers compared, each with its limit, end standard error.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "exp_ldpc_tpu")
PORT = "exp_ldpc_tpu_torch"


def parse_args(argv):
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json on one card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load(root: Path, workload: str):
    """(bench, cell, cfg, traffic) of a workload of ``root/BENCHMARK.json``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: {sorted(cells)}")
    cell = cells[workload]
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, cfg, traffic


def forbidden_modules():
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def reference_matrices(cfg: dict, root: Path):
    """(hx, hz, lz) of the configuration's code, read by the reference;
    ``lz``, the Z logicals, where the code's file states them, else None."""
    from .reference.codes import bivariate_bicycle, read_qecc

    c = cfg["code"]
    if c["kind"] == "qecc":
        q = read_qecc(root / "benchmark" / "configs" / c["file"])
        return q["hx"], q["hz"], q["lz"]
    return (*bivariate_bicycle(c["l"], c["m"], c["a_terms"], c["b_terms"]), None)


def decode_mode(traffic: dict):
    """The module of the traffic's decode mode (``benchmark/modes/``): the
    traffic's ``mode_module``, else its ``mode`` (a variant of a program
    mode, such as ``bposd`` with ``tier1_iters`` among its ``options``,
    names a module of its own)."""
    name = traffic.get("mode_module", traffic["mode"])
    return importlib.import_module(f"benchmark.modes.{name}")


def metric_names(bench: dict, workload: str, kind: str):
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def trace_ctx(summary: dict, batches: int, counters: dict, bound_ms: float) -> dict:
    """What the per-layer readers read (:mod:`.metrics`)."""
    return {**summary, "batches": batches, "counters": counters, "bound_ms": bound_ms}


def run(args, root: Path, device, t0: float, sizes=None):
    """One run on ``device``: (result dict, the check's lines).  ``sizes``
    overrides keys of the configuration and the traffic (the CPU tests run
    a cell at a size they can hold)."""
    import torch

    from . import check, trace
    from .capture import Reservoir
    from .reference.experiment import Experiment

    bench, cell, cfg, traffic = load(root, args.workload)
    if sizes:
        cfg = {**cfg, **{k: v for k, v in sizes.items() if k in cfg}}
        traffic = {**traffic, **{k: v for k, v in sizes.items() if k in traffic}}
    entry = importlib.import_module(f"benchmark.entries.{traffic['entry']}").Entry(
        cfg, traffic, args.seed, device, root)
    entry.setup()
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    setup_s = time.perf_counter() - t0

    res = Reservoir(traffic["compare_batches"], args.seed)
    entry.instrument(res, trace.span_factory(bool(args.trace)))
    prof = window = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
        window = record_function(trace.WINDOW)
        window.__enter__()
    attempted = failed = shots = units = 0
    counters = {}
    traced = None
    unit_s = []
    t_start = time.perf_counter()
    while True:
        t_unit = time.perf_counter()
        try:
            out = entry.run_unit(units)
        except RuntimeError as exc:     # a batch that raises is a failed operation
            print(f"unit {units} failed: {exc}", file=sys.stderr)
            out = {"shots": 0, "batches": int(traffic["batches_per_point"])}
            failed += out["batches"]
        units += 1
        unit_s.append(time.perf_counter() - t_unit)
        attempted += out["batches"]
        shots += out["shots"]
        if "osd_shots" in out:
            counters["osd_shots"] = counters.get("osd_shots", 0) + out["osd_shots"]
        if prof is not None and units == int(traffic["trace_units"]):
            sync()
            window.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            traced = (attempted, dict(counters))
        if time.perf_counter() - t_start >= args.seconds:
            break
    sync()
    wall = time.perf_counter() - t_start
    if prof is not None and traced is None:
        window.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        traced = (attempted, dict(counters))
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    kept = res.slots
    entry.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: {found}")

    hx, hz, lz = reference_matrices(cfg, root)
    exp = Experiment(hx, hz, cfg["rounds"], traffic["p"], cfg, device, lz=lz)
    mode = decode_mode(traffic)
    prec = cfg["precision"]
    numbers = check.numbers(exp, mode, entry.captured(kept, exp, mode), prec["device_stage"],
                            prec.get("host_redecode", "bfloat16"))
    limits = traffic["limits"]
    correct = all(limits.get(k) is not None and v <= limits[k] for k, v in numbers.items())
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}

    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed}
    if not args.trace:
        values = {"shots_per_s": shots / wall, "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in metric_names(bench, args.workload, "end_to_end")}
    else:
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            summary = trace.read(path)
        finally:
            os.unlink(path)
        bound_ms = mode.bound_ms(hz, int(cfg["rounds"]), int(cfg["shots_per_batch"]),
                                 int(cfg["bp"]["max_iter"]))
        ctx = trace_ctx(summary, traced[0], traced[1], bound_ms)
        metrics = {}
        for m in metric_names(bench, args.workload, "per_layer"):
            v = importlib.import_module(f"benchmark.metrics.{m['name']}").read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = metrics
        dev_info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
        result["layers"] = {"device_s": summary["layer_device_s"],
                            "host_s": summary["layer_host_s"], "batches": traced[0]}
    result["device"] = dev_info
    result["run"] = {"units": units, "shots": shots, "window_s": wall, "setup_s": setup_s,
                     "unit_s": unit_s}
    result["checks"] = checks
    lines = [f"check {k}: {c['value']} (limit {c['limit']})" for k, c in checks.items()]
    return result, lines


def main(argv, t0: float) -> int:
    args = parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    if not (root / PORT / "__init__.py").is_file():
        print(f"no {PORT} package beside the benchmark in {root}", file=sys.stderr)
        return 2
    # one thread for torch's CPU pool, set before torch loads: the native
    # OSD's workers take every core, and a pool of as many threads beside
    # them cost the OSD-bound cell a fifth to two fifths of its rate, by an
    # amount that swung from run to run
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch

    torch.set_num_threads(1)
    _bench, cell, _cfg, _traffic = load(root, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, lines = run(args, root, torch.device("cuda"), t0)
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
