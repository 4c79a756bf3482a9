"""Logging, throughput metrics, and profiler tracing.

Counterpart of ``exp_ldpc_tpu/utils/observability.py``, with the same names
and behaviour:

  * :func:`get_logger`: loggers under the ``exp_ldpc_tpu_torch`` namespace;
    the level comes from the ``EXP_LDPC_TPU_TORCH_LOG`` environment variable
    (default WARNING, so library use is silent);
  * :class:`Metrics`: named monotonic counters with derived rates (shots
    decoded/s, BP iterations/s, ...), cheap enough to leave on;
  * :func:`profiler_trace`: a context manager around ``torch.profiler`` that
    writes a Chrome trace of everything inside it (device activity too when
    a CUDA card is present);
  * :func:`timed`: a walltime context manager that logs (and optionally
    accumulates into a :class:`Metrics`); given a CUDA device it
    synchronises it before reading the clock on both sides, so the time is
    the device's work and not its enqueueing.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, Optional

__all__ = ["get_logger", "Metrics", "profiler_trace", "timed"]

_ROOT = "exp_ldpc_tpu_torch"
_ENV = "EXP_LDPC_TPU_TORCH_LOG"
_configured = False


def get_logger(name: str = "") -> logging.Logger:
    """Logger under the ``exp_ldpc_tpu_torch`` namespace.

    The level comes from ``EXP_LDPC_TPU_TORCH_LOG`` (DEBUG/INFO/WARNING/
    ERROR); a handler is attached once, to the package root only, so
    embedding applications keep full control through standard logging
    configuration.
    """
    global _configured
    root = logging.getLogger(_ROOT)
    if not _configured:
        level = os.environ.get(_ENV, "WARNING").upper()
        root.setLevel(getattr(logging, level, logging.WARNING))
        if not root.handlers:
            h = logging.StreamHandler()
            h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
            root.addHandler(h)
        _configured = True
    return root if not name else logging.getLogger(f"{_ROOT}.{name}")


@dataclass
class Metrics:
    """Named monotonic counters with wall-clock rates.

    >>> m = Metrics()
    >>> m.add("shots", 4096); m.add("bp_iters", 4096 * 32)
    >>> m.report()  # {'shots': ..., 'shots_per_s': ..., ...}
    """

    counters: Dict[str, float] = field(default_factory=dict)
    _t0: float = field(default_factory=time.perf_counter)

    def add(self, name: str, value: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + float(value)

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def reset(self) -> None:
        self.counters.clear()
        self._t0 = time.perf_counter()

    def report(self) -> Dict[str, float]:
        dt = max(self.elapsed(), 1e-12)
        out: Dict[str, float] = {"elapsed_s": dt}
        for k, v in self.counters.items():
            out[k] = v
            out[f"{k}_per_s"] = v / dt
        return out

    def log(self, logger: Optional[logging.Logger] = None, level=logging.INFO) -> None:
        (logger or get_logger("metrics")).log(
            level, " ".join(f"{k}={v:.6g}" for k, v in sorted(self.report().items())))


@contextlib.contextmanager
def profiler_trace(log_dir: str) -> Iterator[object]:
    """Trace the enclosed block with ``torch.profiler`` (host activity, and
    the device's when a CUDA card is present) and write it as a Chrome trace
    (``trace.json``) under ``log_dir``.  Yields the profiler, whose
    ``key_averages()`` and ``events()`` the caller may read after the block.
    Degrades to a traceless block with a warning where the profiler cannot
    start, as the reference does."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    log = get_logger("profiler")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    try:
        prof = profile(activities=activities)
        prof.__enter__()
    except Exception as e:  # pragma: no cover - platform dependent
        log.warning("profiler unavailable: %s", e)
        yield None
        return
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        try:
            prof.__exit__(None, None, None)
            out = Path(log_dir)
            out.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(out / "trace.json"))
        except Exception as e:  # pragma: no cover
            log.warning("stopping the profiler failed: %s", e)


@contextlib.contextmanager
def timed(name: str, *, metrics: Optional[Metrics] = None,
          logger: Optional[logging.Logger] = None, level=logging.DEBUG,
          device=None) -> Iterator[None]:
    """Log the walltime of the enclosed block (and count it into metrics).
    With a CUDA ``device`` the device is synchronised before each clock
    reading."""
    import torch

    def sync():
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sync()
        dt = time.perf_counter() - t0
        if metrics is not None:
            metrics.add(f"{name}_s", dt)
            metrics.add(f"{name}_calls", 1)
        (logger or get_logger("timing")).log(level, "%s took %.4fs", name, dt)
