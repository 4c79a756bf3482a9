"""The port's own host modules against their originals in the JAX package.

The port imports nothing of ``exp_ldpc_tpu``; it carries copies of the
modules there that import no JAX (codes, circuits, GF(2) tools and their C++
library, Tanner tables, spacetime codes, OSD, DEM tools, the CPU sampler).
Each copy is held to its original, byte for byte outside three kinds of
difference:

  * every file: a docstring that cites the reference implementation by an
    absolute path cites it relative to the reference's root instead
    (:func:`_normalised`);
  * ``native/__init__.py``, line 28: the compiled library is cached under
    the checkout's ``build/exp_ldpc_tpu_torch/`` (``EXP_LDPC_TPU_TORCH_CACHE``
    overrides), not under the home directory;
  * ``decoders/osd.py``, lines 31, 147-153 and 172-180: the OSD solve (the
    C++ call, and the numpy fallback's loop) runs inside the program's span
    ``ldpc.redecode.osd`` (:mod:`exp_ldpc_tpu_torch.utils.observability`),
    the line count kept.

Functions of JAX-importing modules whose own code needs no JAX are copied
into the port's counterparts and held to their originals the same way,
function by function: ``flip.py``'s numpy oracles and subset tables,
``sliding_window.window_check_matrix`` (:data:`COPIED_FUNCTIONS`).

And the two packages give equal results where the port's path uses these
modules: HGP-225's check matrices and logicals, its storage circuit text,
the ``TannerELL`` tables, a spacetime check matrix, an OSD decode (C++ and
numpy paths) and the CPU frame sampler.
"""
import re
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
ORIG, COPY = REPO / "exp_ldpc_tpu", REPO / "exp_ldpc_tpu_torch"

COPIED = sorted(
    ["core.py", "noise_model.py", "code_examples.py", "utils/gf2.py", "utils/fields.py",
     "native/__init__.py", "native/gf2_kernels.cpp", "decoders/tanner.py",
     "decoders/spacetime.py", "decoders/osd.py", "decoders/dem.py", "decoders/ml.py",
     "decoders/bp_numpy.py", "sampler/reference.py", "experiments/generate_hgp.py"]
    + [f"codes/{p.name}" for p in (ORIG / "codes").glob("*.py")]
    + [f"circuits/{p.name}" for p in (ORIG / "circuits").glob("*.py")])

# file -> 1-based numbers of the lines that may differ
ALLOWED = {"native/__init__.py": {28},
           "decoders/osd.py": {31, *range(147, 154), *range(172, 181)}}


def _normalised(text: str) -> str:
    """Citations of the reference implementation lose their absolute prefix."""
    return re.sub(r"/[a-z]+/(?=reference/)", "", text)


def test_every_host_module_is_copied():
    assert len(COPIED) == 33
    assert sum(name.startswith("codes/") for name in COPIED) == 13
    assert sum(name.startswith("circuits/") for name in COPIED) == 5
    assert not (COPY / "_host.py").exists()


@pytest.mark.parametrize("name", COPIED)
def test_copy_equals_original(name):
    want = _normalised((ORIG / name).read_text()).split("\n")
    got = (COPY / name).read_text().split("\n")
    assert len(got) == len(want)
    differ = {i + 1 for i, (a, b) in enumerate(zip(want, got)) if a != b}
    assert differ == ALLOWED.get(name, set()), sorted(differ)
    assert not re.search(r"^\s*(import|from)\s+(jax|exp_ldpc_tpu\b(?!_torch))",
                         "\n".join(got), re.M)


# module -> functions the port's counterpart carries as copies of the originals
COPIED_FUNCTIONS = {
    "decoders/flip.py": ["_dense01", "flip_decode_numpy", "_ssf_tables", "ssf_decode_numpy"],
    "decoders/sliding_window.py": ["window_check_matrix"],
}


def _functions(path: Path) -> dict:
    """Top-level function name -> its source text, from a file (not imported)."""
    import ast

    text = path.read_text()
    return {node.name: ast.get_source_segment(text, node)
            for node in ast.parse(text).body if isinstance(node, ast.FunctionDef)}


@pytest.mark.parametrize("name", sorted(COPIED_FUNCTIONS))
def test_copied_functions_equal_originals(name):
    """The numpy oracles the port's tests hold its decoders to are the port's
    own copies (defined in its module, not imported from the JAX package),
    equal to the originals line for line."""
    want, got = _functions(ORIG / name), _functions(COPY / name)
    for fn in COPIED_FUNCTIONS[name]:
        assert got[fn] == _normalised(want[fn]), fn
    assert "exp_ldpc_tpu." not in (COPY / name).read_text()


@pytest.fixture(scope="module")
def both():
    """(JAX package's modules, port's modules) by name."""
    import importlib

    names = ["codes.hgp", "circuits.noise", "circuits.storage_sim", "circuits.ir",
             "decoders.tanner", "decoders.spacetime", "decoders.osd", "sampler.reference",
             "utils.gf2", "native"]
    return tuple({n: importlib.import_module(f"{pkg}.{n}") for n in names}
                 for pkg in ("exp_ldpc_tpu", "exp_ldpc_tpu_torch"))


def _hgp225(mods):
    return mods["codes.hgp"].biregular_hgp(12, 3, 4, seed=0, compute_logicals=True)


def test_hgp225_equal(both):
    a, b = (_hgp225(m) for m in both)
    for part in ("checks", "logicals"):
        for sector in ("x", "z"):
            ma, mb = (getattr(getattr(c, part), sector) for c in (a, b))
            ma, mb = (x.toarray() if hasattr(x, "toarray") else np.asarray(x) for x in (ma, mb))
            np.testing.assert_array_equal(ma, mb)
    assert type(a).__module__ == "exp_ldpc_tpu.core"
    assert type(b).__module__ == "exp_ldpc_tpu_torch.core"


def test_storage_circuit_text_equal(both):
    texts = []
    for m in both:
        sim = m["circuits.storage_sim"].build_storage_simulation(
            4, m["circuits.noise"].depolarizing_noise(3e-3, 3e-3), _hgp225(m))
        texts.append(sim.circuit)
        parsed = m["circuits.ir"].parse_circuit(sim.circuit)
        texts.append(repr(parsed.noise_args()))
    assert texts[0] == texts[2] and texts[1] == texts[3] and len(texts[0]) > 1000


def test_tanner_and_spacetime_tables_equal(both):
    tabs = []
    for m in both:
        H = _hgp225(m).checks.z
        t = m["decoders.tanner"].TannerELL.from_check_matrix(H)
        st = m["decoders.spacetime"].SpacetimeCode(H, 4).spacetime_check_matrix.tocsr()
        ss = m["decoders.spacetime"].SpacetimeCodeSingleShot(H).spacetime_check_matrix.tocsr()
        tabs.append((t, st, ss))
    (ta, sa, ssa), (tb, sb, ssb) = tabs
    for field in ("chk_vars", "chk_mask", "vm_from_cm", "cm_from_vm"):
        np.testing.assert_array_equal(getattr(ta, field), getattr(tb, field))
    assert (ta.num_checks, ta.num_vars, ta.max_check_degree, ta.max_var_degree) == \
        (tb.num_checks, tb.num_vars, tb.max_check_degree, tb.max_var_degree)
    assert (sa != sb).nnz == 0 and (ssa != ssb).nnz == 0


@pytest.mark.parametrize("native", [True, False], ids=["cpp", "numpy"])
def test_osd_decode_equal(both, native, monkeypatch):
    """The same OSD-CS decode from both packages, through the C++ library
    and through the numpy path."""
    rng = np.random.default_rng(0)
    outs = []
    for m in both:
        lib = m["native"].get_gf2_lib()
        assert lib is not None
        if not native:
            monkeypatch.setattr(m["native"], "_lib", None)
        H = _hgp225(m).checks.z
        err = (rng.random((24, H.shape[1])) < 0.02).astype(np.uint8)
        synd = (err @ H.T.toarray()) % 2
        llr = rng.normal(3.0, 2.0, size=(24, H.shape[1])).astype(np.float32)
        out = m["decoders.osd"].osd_decode_batch(H, synd.astype(np.uint8), llr,
                                                 osd_method="osd_cs", osd_order=4)
        assert (((out @ H.T.toarray()) % 2) == synd).all()
        outs.append(out)
        rng = np.random.default_rng(0)
    np.testing.assert_array_equal(outs[0], outs[1])


def test_native_library_is_the_ports_own(both):
    a, b = (m["native"] for m in both)
    assert a._SRC != b._SRC and b._SRC.parent == COPY / "native"
    assert a.get_gf2_lib() is not None and b.get_gf2_lib() is not None
    assert a.get_gf2_lib() is not b.get_gf2_lib()
    M = (np.random.default_rng(1).random((40, 60)) < 0.2).astype(np.uint8)
    assert both[0]["utils.gf2"].rank(M) == both[1]["utils.gf2"].rank(M)


def test_frame_sampler_equal(both):
    recs = []
    for m in both:
        sim = m["circuits.storage_sim"].build_storage_simulation(
            2, m["circuits.noise"].depolarizing_noise(5e-3, 5e-3), _hgp225(m))
        recs.append(m["sampler.reference"].FrameSampler(sim.circuit, seed=7).sample_detectors(64))
    np.testing.assert_array_equal(recs[0], recs[1])
    assert recs[0].any()
