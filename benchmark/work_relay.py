"""The least time an H100 could take for a batch's relay decode: the
yardstick of ``relay_roofline`` and of the relay cell's ``decode_roofline``.

A frozen copy of the program's ``utils/bounds.py::relay_bound`` (kernel
K10's bound, with ``bound``, ``flat_io`` and ``OPS_FLOAT`` of the frozen
``benchmark/bounds.py``), kept here so that a change to the program cannot
move the yardstick: the inputs read once (syndromes, priors, the Tanner
tables, the (legs, V) float32 gamma table) and the outputs written once
(posterior, converged, solving leg), over 3.35 TB/s; or ``OPS_FLOAT`` an
edge and ``OPS_MEMORY`` a variable (the memory term: the prior added, two
products, a sum), each shot and iteration of leg 0 alone, over the card's
float32 rate.  The later legs' work depends on the data and is not
counted, so the share errs high.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .bounds import OPS_FLOAT, bound, flat_io
from .reference.codes import bivariate_bicycle, spacetime_matrix
from .work import Tab

OPS_MEMORY = 4
CONFIG = Path(__file__).resolve().parent / "configs" / "gross144x12relay.json"


def relay_bound(tab, nnz: int, shots: int, iters: int, legs: int) -> dict:
    """The bound of one relay decode of ``shots`` shots over a matrix of
    ``nnz`` edges (its table sizes ``tab``), ``iters`` iterations a leg."""
    ops = (OPS_FLOAT * nnz + OPS_MEMORY * tab.num_vars) * shots * iters
    return bound(flat_io(tab, shots) + 4 * legs * tab.num_vars, ops)


def relay_bound_ms(h: np.ndarray, rounds: int, shots: int, iters: int, legs: int) -> float:
    """The least time of the relay decode of the spacetime matrix of ``h``
    over ``rounds`` rounds."""
    st = spacetime_matrix(np.asarray(h, dtype=np.int64) % 2, rounds)
    return relay_bound(Tab(st), int(st.sum()), shots, iters, legs)["bound_ms"]


def _config(path):
    """(spacetime matrix, configuration) of a relay configuration: its
    code's Z checks over its rounds."""
    cfg = json.loads(Path(path).read_text())
    c = cfg["code"]
    _hx, hz = bivariate_bicycle(c["l"], c["m"], c["a_terms"], c["b_terms"])
    return spacetime_matrix(hz, int(cfg["rounds"])), cfg


def config_shape(path=CONFIG) -> tuple:
    """(checks, variables, edges, shots a batch, iterations a leg, legs) of
    a relay configuration."""
    st, cfg = _config(path)
    return (st.shape[0], st.shape[1], int(st.sum()), int(cfg["shots_per_batch"]),
            int(cfg["bp"]["max_iter"]), int(cfg["relay"]["legs"]))


def config_bound_ms(path=CONFIG) -> float:
    """The least time of one batch of a relay configuration."""
    st, cfg = _config(path)
    return relay_bound(Tab(st), int(st.sum()), int(cfg["shots_per_batch"]),
                       int(cfg["bp"]["max_iter"]), int(cfg["relay"]["legs"]))["bound_ms"]
