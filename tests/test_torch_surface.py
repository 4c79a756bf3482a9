"""The port's public surface against the JAX package's.

* The four ``__all__`` lists (the package, ``decoders``, ``parallel``,
  ``misc``) equal the JAX package's as sets (40 / 25 / 8 / 11 names), and
  each name comes from the port's counterpart of its JAX module.
* In a subprocess where ``import jax`` fails (``test_torch_no_jax``'s
  ``_BLOCK_JAX`` / ``_CHECK_CLEAN``), every name resolves in either import
  order (the package first, or ``decoders.bp_bsr_shard`` first, whose
  ``..parallel.mesh`` pulls in ``parallel/__init__``), and the import builds
  nothing: no file appears in the ``EXP_LDPC_TPU_TORCH_CACHE`` directory or
  in ``build/exp_ldpc_tpu_torch/``, no shared library is loaded from either,
  none of the six CUDA kernels K1-K6 has been built, and neither CUDA nor
  ``torch.distributed`` is initialised.
* The README quickstart runs with the package name swapped (64 samples on
  the CPU), and so does the port section's.
* ``qldpc-generate-hgp-torch``'s entry point in ``pyproject.toml`` resolves,
  and its ``main`` writes the same code and circuit files as the JAX CLI's.
"""
import importlib
import re
import tomllib
from pathlib import Path

import pytest
import torch

from test_torch_no_jax import _BLOCK_JAX, _CHECK_CLEAN, _run

REPO = Path(__file__).resolve().parent.parent
SUBPACKAGES = {"": 40, ".decoders": 25, ".parallel": 8, ".misc": 11}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("sub", list(SUBPACKAGES), ids=lambda s: s or "package")
def test_all_equals_jax(sub):
    jax_mod = importlib.import_module("exp_ldpc_tpu" + sub)
    mod = importlib.import_module("exp_ldpc_tpu_torch" + sub)
    assert set(mod.__all__) == set(jax_mod.__all__)
    assert len(mod.__all__) == len(set(mod.__all__)) == SUBPACKAGES[sub]
    for name in mod.__all__:
        a, b = getattr(jax_mod, name), getattr(mod, name)
        if isinstance(a, (str, dict)):   # DATA_AXIS, MODEL_AXIS, BB_CODES
            assert a == b, name
            continue
        where = getattr(a, "__module__", None) or a.__name__   # a module alias: its name
        assert (getattr(b, "__module__", None) or b.__name__) == where.replace(
            "exp_ldpc_tpu", "exp_ldpc_tpu_torch", 1), name


_IMPORT_ORDERS = {
    "package_first": "import exp_ldpc_tpu_torch\nimport exp_ldpc_tpu_torch.decoders.bp_bsr_shard\n",
    "shard_first": "import exp_ldpc_tpu_torch.decoders.bp_bsr_shard\nimport exp_ldpc_tpu_torch\n",
}


@pytest.mark.parametrize("order", list(_IMPORT_ORDERS))
def test_surface_resolves_without_jax_and_builds_nothing(order, tmp_path):
    build = REPO / "build" / "exp_ldpc_tpu_torch"
    proc = _run(_BLOCK_JAX + f"""
import os
os.environ["EXP_LDPC_TPU_TORCH_CACHE"] = {str(tmp_path)!r}
from pathlib import Path
build = Path({str(build)!r})
before = sorted(build.iterdir()) if build.is_dir() else []
""" + _IMPORT_ORDERS[order] + f"""
import importlib
for sub, count in {SUBPACKAGES!r}.items():
    mod = importlib.import_module("exp_ldpc_tpu_torch" + sub)
    assert len(mod.__all__) == count, sub
    for name in mod.__all__:
        assert getattr(mod, name) is not None, (sub, name)
from exp_ldpc_tpu_torch.misc import p_sweep_main  # noqa: F401
from exp_ldpc_tpu_torch.utils.cuda_build import CudaKernel
import torch
import torch.distributed as dist
assert not list(Path({str(tmp_path)!r}).iterdir()), "the import wrote to the cache"
after = sorted(build.iterdir()) if build.is_dir() else []
assert after == before, "the import wrote to build/exp_ldpc_tpu_torch"
roots = (os.path.realpath({str(tmp_path)!r}), os.path.realpath(str(build)))
files = [getattr(m, "__file__", None) or "" for m in list(sys.modules.values())]
with open("/proc/self/maps") as f:
    files += [line.split()[-1] for line in f if "/" in line]
assert not [f for f in files if f.endswith(".so") and os.path.realpath(f).startswith(roots)]
from exp_ldpc_tpu_torch.decoders import (bp_bsr, bp_bsr_shard, bp_bsr_spacetime, bp_cuda,
                                         spacetime_bp_cuda)
kernels = [bp_bsr.KERNEL, bp_bsr.KERNEL_INT8, spacetime_bp_cuda.KERNEL, bp_bsr_spacetime.KERNEL,
           bp_bsr_shard.KERNEL, bp_cuda.KERNEL]
assert all(isinstance(k, CudaKernel) and k._fn is None and k._lib is None for k in kernels)
assert not dist.is_initialized() and not torch.cuda.is_initialized()
""" + _CHECK_CLEAN + "print('OK')")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "OK"


def _readme_block(section: str) -> str:
    text = (REPO / "README.md").read_text()
    return re.search(section + r".*?```python\n(.*?)```", text, re.S).group(1)


@pytest.mark.parametrize("section", ["## Quickstart", "### Quickstart on the card"])
def test_readme_quickstart_runs(section, capsys):
    """The README's quickstart (the JAX package's with the package name
    swapped; the port section's as written) at 64 samples on the CPU."""
    code = _readme_block(section).replace("exp_ldpc_tpu", "exp_ldpc_tpu_torch") \
        if section == "## Quickstart" else _readme_block(section)
    assert code.count("samples=4096") == 1
    code = code.replace("samples=4096", "samples=64")
    if section == "## Quickstart":
        code = code.replace('seed=0)', 'seed=0, device="cpu")')
    else:
        assert code.count('device="cuda"') == 1
        code = code.replace('device="cuda"', 'device="cpu"')
    assert "import exp_ldpc_tpu_torch as qldpc" in code and 'device="cpu"' in code
    scope = {}
    exec(compile(code, f"README {section}", "exec"), scope)
    assert (scope["code"].num_qubits, scope["code"].num_logicals) == (225, 9)
    assert len(scope["failures"]) == 64
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("RZ 0 1 2") and out[-1].endswith(" logical failures")


def test_generate_hgp_console_script(tmp_path):
    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())["project"]["scripts"]
    assert scripts["qldpc-generate-hgp-torch"] == "exp_ldpc_tpu_torch.experiments.generate_hgp:main"
    outs = {}
    for tag in ("qldpc-generate-hgp", "qldpc-generate-hgp-torch"):
        module, attr = scripts[tag].split(":")
        main = getattr(importlib.import_module(module), attr)
        code, circ = tmp_path / f"{tag}.qecc", tmp_path / f"{tag}.stim"
        main(["4", "3", "12", "--rounds", "2", "--seed", "7", "--compute_logicals",
              "--save_code", str(code), "--save_circuit", str(circ)])
        outs[tag] = (code.read_text(), circ.read_text())
    assert outs["qldpc-generate-hgp-torch"] == outs["qldpc-generate-hgp"]
    assert outs["qldpc-generate-hgp"][0].strip() and "TICK" in outs["qldpc-generate-hgp"][1]
