"""JAX-free host modules of ``exp_ldpc_tpu``, loaded without its package inits.

Importing any ``exp_ldpc_tpu`` submodule the normal way runs
``exp_ldpc_tpu/__init__.py``, which imports ``decoders/__init__.py``, which
imports the JAX decoders.  The machine the port targets has no JAX, so this
module loads the host-only files (code construction, circuits, the CPU
samplers, Tanner tables, OSD and its C++ kernel) under a private alias
package instead:

  * synthetic package modules with empty bodies are registered under
    ``exp_ldpc_tpu_torch._host_pkg`` whose ``__path__`` points at the real
    ``exp_ldpc_tpu/`` directories, so no ``__init__.py`` of the JAX package
    runs;
  * the submodules are then imported through the alias; their relative
    imports (``from ..core import ...``) resolve inside it.

The files are shared, not copied: the JAX package stays the single source
of these modules.  ``native/`` is imported for real (its ``__init__`` is
the C++ loader and imports no JAX).
"""
from __future__ import annotations

import importlib
import sys
import types
from pathlib import Path

_ALIAS = __name__ + "_pkg"
_ROOT = Path(__file__).resolve().parent.parent / "exp_ldpc_tpu"
# packages whose __init__ must not run (decoders/__init__ imports JAX)
_SYNTHETIC = ("", "codes", "circuits", "decoders", "sampler", "utils")


def _register() -> None:
    if not (_ROOT / "core.py").is_file():
        raise ImportError(f"exp_ldpc_tpu sources not found at {_ROOT}")
    for sub in _SYNTHETIC:
        name = _ALIAS + ("." + sub if sub else "")
        if name in sys.modules:
            continue
        mod = types.ModuleType(name)
        mod.__path__ = [str(_ROOT / sub) if sub else str(_ROOT)]
        mod.__package__ = name
        sys.modules[name] = mod
        if sub:
            setattr(sys.modules[_ALIAS], sub, mod)


def load(relname: str) -> types.ModuleType:
    """Import ``exp_ldpc_tpu.<relname>`` through the alias package."""
    _register()
    return importlib.import_module(f"{_ALIAS}.{relname}")


core = load("core")
hgp = load("codes.hgp")
graphs = load("codes.graphs")
homological = load("codes.homological")
fields = load("utils.fields")
lifted = load("codes.lifted")
io = load("codes.io")
ir = load("circuits.ir")
noise = load("circuits.noise")
storage_sim = load("circuits.storage_sim")
graph_coloring = load("circuits.graph_coloring")
tanner = load("decoders.tanner")
spacetime = load("decoders.spacetime")
osd = load("decoders.osd")
gf2 = load("utils.gf2")
native = load("native")
reference_sampler = load("sampler.reference")

TannerELL = tanner.TannerELL
SpacetimeCode = spacetime.SpacetimeCode
SpacetimeCodeSingleShot = spacetime.SpacetimeCodeSingleShot
parse_circuit = ir.parse_circuit
build_storage_simulation = storage_sim.build_storage_simulation
depolarizing_noise = noise.depolarizing_noise
biregular_hgp = hgp.biregular_hgp
read_quantum_code = io.read_quantum_code
osd_decode_batch = osd.osd_decode_batch
FrameSampler = reference_sampler.FrameSampler
