"""Logging, the program's spans and counters, and profiler tracing.

  * :func:`get_logger`: loggers under the ``exp_ldpc_tpu_torch`` namespace;
    the level comes from the ``EXP_LDPC_TPU_TORCH_LOG`` environment variable
    (default WARNING, so library use is silent);
  * :func:`tracing`, :func:`span`, :func:`count`, :func:`counters`: the
    program's own spans and counters, off unless a :func:`tracing` block is
    open.  Off, :func:`span` returns one shared do-nothing context and
    :func:`count` returns at once: a flag read each, no allocation, nothing
    on the card.  On, ``span(name)`` is ``torch.profiler.record_function
    ("ldpc." + name)``, so the spans land in the profiler's Chrome trace
    beside the device operations, on the same clock, each inside the
    innermost ``ldpc.`` span open on its thread; :func:`count` adds integers
    the program already holds on the host (shapes, ``nbytes``, values read
    back by a copy the program makes anyway), never a value that would need
    a device sync or a copy of its own;
  * :func:`profiler_trace`: a context manager around ``torch.profiler`` that
    writes a Chrome trace of everything inside it (device activity too when
    a CUDA card is present).

The spans, from the sweep down (``ldpc.`` prefix; parent first):
``point`` (a sweep point), ``rebind`` and ``rebind.osd_build`` (the noise
rebound between points), ``batch``, ``sample``, ``decode`` with
``decode.bp`` (each BP stage), ``decode.relay`` (the relay ensemble's
stage, kernel K10 on a card) and ``decode.fold``, ``ship`` (the copy of
the shipped readout to the host), ``redecode`` (a memory mode's driver,
the host BP+OSD redecode in the pipeline) with ``redecode.bp`` and
``redecode.osd``.  The counters: ``ship_bytes`` (bytes ``ship`` copies),
``osd_solves`` (shots handed to OSD after the redecode's BP),
``osd_device_solves`` (those of them on kernel K8's device route, the
matrix past one block's shared memory), ``sample_kernel`` (batches
``sample`` drew with kernel K9, the sampler on a CUDA device),
``relay_legs`` (the deepest leg a relay batch ran) and ``relay_tail_shots``
(its shots that needed a leg after leg 0), both read from the relay
stage's solving legs with the batch's counts, in the one copy the fold
makes.
"""
from __future__ import annotations

import contextlib
import logging
import os
import threading
from pathlib import Path
from typing import Dict, Iterator

from torch.profiler import record_function

__all__ = ["get_logger", "tracing", "span", "count", "counters", "profiler_trace"]

_ROOT = "exp_ldpc_tpu_torch"
_ENV = "EXP_LDPC_TPU_TORCH_LOG"
_configured = False

PREFIX = "ldpc."
_OFF = contextlib.nullcontext()
_on = False
_counts: Dict[str, int] = {}
_lock = threading.Lock()


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


@contextlib.contextmanager
def tracing() -> Iterator[None]:
    """Turn the program's spans and counters on for the enclosed block; the
    counters start from zero.  The block's spans reach a trace only where
    a ``torch.profiler`` session is open around them."""
    global _on
    with _lock:
        _counts.clear()
    was, _on = _on, True
    try:
        yield
    finally:
        _on = was


def span(name: str):
    """A context around one piece of the program's work: the profiler range
    ``ldpc.<name>`` while tracing is on, the shared do-nothing context
    while it is off."""
    if not _on:
        return _OFF
    return record_function(PREFIX + name)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if not _on:
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + int(n)


def counters() -> Dict[str, int]:
    """A snapshot of the counters, by name."""
    with _lock:
        return dict(_counts)


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
