"""Port: the automatic decoder choice of exp_ldpc_tpu_torch/decoders/select.py
against the JAX package's rule on the same codes.

The JAX package routes a code to its BSR kernels only where their TPU VMEM
estimate fits (``_bsr_usable`` asks ``fits_bsr``, ``_stbsr_usable`` asks
``fits_stbsr``); the port keeps that arithmetic, computed on its own
``BSRLayout``, so both packages give each code the same decode contract.  A
CUDA device stands in for the reference's TPU: ``bsr_selected`` /
``stbsr_selected`` are asked about a ``torch.device("cuda")`` object, which
needs no card.
"""
import pytest
import torch

from exp_ldpc_tpu.decoders.bp_bsr import fits_bsr as jax_fits_bsr
from exp_ldpc_tpu.decoders.bp_bsr_spacetime import fits_stbsr as jax_fits_stbsr
from exp_ldpc_tpu.decoders.select import _dense_ops_bytes
from exp_ldpc_tpu.decoders.tanner import TannerELL as JaxTannerELL
from exp_ldpc_tpu_torch.codes.bivariate_bicycle import gross_code
from exp_ldpc_tpu_torch.codes.hgp import biregular_hgp
from exp_ldpc_tpu_torch.decoders import select
from exp_ldpc_tpu_torch.decoders.bp import BPDecoder
from exp_ldpc_tpu_torch.decoders.bp_bsr import BSRBPDecoder, BSRLayout
from exp_ldpc_tpu_torch.decoders.bp_bsr_spacetime import SpacetimeBSRDecoder
from exp_ldpc_tpu_torch.decoders.spacetime import SpacetimeCodeSingleShot
from exp_ldpc_tpu_torch.decoders.spacetime_bp import SpacetimeBPDecoder
from exp_ldpc_tpu_torch.decoders.tanner import TannerELL

torch.set_num_threads(1)
CUDA, CPU = torch.device("cuda"), torch.device("cpu")
MiB = 2**20


def _hgp225():
    return biregular_hgp(12, 3, 4, seed=0).checks.z


CODES = {
    "hgp225": _hgp225,
    "hgp225 (H|I)": lambda: SpacetimeCodeSingleShot(_hgp225()).spacetime_check_matrix,
    "gross": lambda: gross_code().checks.z,
    "hgp n=10000": lambda: biregular_hgp(80, 3, 4, seed=7).checks.z,
    "hgp n=15625": lambda: biregular_hgp(100, 3, 4, seed=0).checks.z,
    "hgp n=40000": lambda: biregular_hgp(160, 3, 4, seed=11).checks.z,
}


@pytest.mark.parametrize("name", list(CODES))
def test_fit_rule_equals_jax(name):
    """The port's rule on a CUDA device equals JAX's ``_dense_ops_bytes >=
    1 MiB and fits_*`` for K1 and K3; the fit arithmetic itself agrees too."""
    H = CODES[name]()
    t, jt = TannerELL.from_check_matrix(H), JaxTannerELL.from_check_matrix(H)
    big = _dense_ops_bytes(jt) >= MiB
    layout = BSRLayout.from_tanner(t, "cpu")
    assert select.fits_bsr(layout) == jax_fits_bsr(jt)
    assert select.fits_stbsr(layout, 4) == jax_fits_stbsr(jt, 4)
    assert select.bsr_selected(t, CUDA) == (big and jax_fits_bsr(jt))
    assert select.stbsr_selected(t, 4, CUDA) == (big and jax_fits_stbsr(jt, 1))
    assert not select.bsr_selected(t, CPU) and not select.stbsr_selected(t, 4, CPU)
    assert not select.stbsr_selected(t, 0, CUDA)


def test_fit_rule_rejects_the_largest_codes():
    """At n = 15,625 and 40,000 neither BSR contract is chosen (the JAX
    package decodes them with the f32 flat and structured decoders), while
    HGP-225 and the n = 10,000 HGP keep K1 / K3."""
    for name, want in (("hgp n=15625", False), ("hgp n=40000", False), ("hgp225", True),
                       ("hgp n=10000", True)):
        t = TannerELL.from_check_matrix(CODES[name]())
        assert select.bsr_selected(t, CUDA) is want, name
        assert select.stbsr_selected(t, 4, CUDA) is want, name


def test_fit_arithmetic_thresholds():
    """The budgets bound: a smaller budget or a larger shot block flips the
    rule at HGP-225, as in the reference."""
    H = _hgp225()
    layout = BSRLayout.from_tanner(TannerELL.from_check_matrix(H), "cpu")
    jt = JaxTannerELL.from_check_matrix(H)
    for sb, budget in ((128, 1 * MiB), (128, 8 * MiB), (4096, 64 * MiB), (128, 64 * MiB)):
        assert select.fits_bsr(layout, sb, budget) == jax_fits_bsr(jt, sb, budget)
    from exp_ldpc_tpu.decoders.bp_bsr import BSRSchedule
    from exp_ldpc_tpu.decoders.bp_bsr_spacetime import fits_stbsr_sched as jax_sched
    sched = BSRSchedule.from_tanner(jt)
    for sb, budget, oh in ((128, 4 * MiB, True), (128, 4 * MiB, False), (1024, 100 * MiB, True),
                           (128, 100 * MiB, True)):
        assert select.fits_stbsr_sched(layout, sb, budget, oh) == jax_sched(sched, sb, budget, oh)


def _classes(monkeypatch):
    """Make the decoder constructors return their class, and every device
    a CUDA one, so that the choice is observed without a card."""
    for cls in (BPDecoder, BSRBPDecoder, SpacetimeBPDecoder, SpacetimeBSRDecoder):
        monkeypatch.setattr(cls, "from_check_matrix",
                            classmethod(lambda c, *a, **k: c))
    monkeypatch.setattr(select, "resolve_device", lambda device: CUDA)


def test_make_decoders_at_n15625_build_the_f32_decoders(monkeypatch):
    """``make_bp_decoder`` / ``make_spacetime_bp_decoder`` on a CUDA device:
    BPDecoder and the structured decoder at n = 15,625 (as JAX builds), K1
    and K3 at HGP-225."""
    from exp_ldpc_tpu.decoders import select as jax_select
    from exp_ldpc_tpu.decoders.bp import BPDecoder as JaxBPDecoder
    from exp_ldpc_tpu.decoders.spacetime_bp import SpacetimeBPDecoder as JaxSpacetimeBPDecoder

    big = biregular_hgp(100, 3, 4, seed=0).checks.z
    assert type(jax_select.make_bp_decoder(big, error_rate=1e-3, max_iter=2)) is JaxBPDecoder
    assert type(jax_select.make_spacetime_bp_decoder(
        big, 2, error_rate=1e-3, max_iter=2)) is JaxSpacetimeBPDecoder
    _classes(monkeypatch)
    assert select.make_bp_decoder(big, error_rate=1e-3) is BPDecoder
    assert select.make_spacetime_bp_decoder(big, 2, error_rate=1e-3) is SpacetimeBPDecoder
    H = _hgp225()
    assert select.make_bp_decoder(H, error_rate=1e-3) is BSRBPDecoder
    assert select.make_spacetime_bp_decoder(H, 2, error_rate=1e-3) is SpacetimeBSRDecoder


def test_pipeline_resolves_through_the_fit_rule(monkeypatch):
    """The pipeline's automatic spacetime stage asks ``stbsr_selected``: K3
    at HGP-225, K2 where the fit rule refuses the code."""
    from exp_ldpc_tpu_torch.parallel import pipeline as pl

    calls = []
    monkeypatch.setattr(pl, "stbsr_selected",
                        lambda t, R, d: calls.append((t.num_vars, R, d.type)) or False)
    stub = type("Stub", (), {"mode": "bposd", "bp_backend": "auto", "early_stop": False,
                             "tanner": TannerELL.from_check_matrix(_hgp225()), "rounds": 4,
                             "device": CUDA})()
    assert pl.StorageDecodePipeline._resolve_kernel(stub) == "stbp"
    assert calls == [(225, 4, "cuda")]
    monkeypatch.setattr(pl, "stbsr_selected", select.stbsr_selected)
    assert pl.StorageDecodePipeline._resolve_kernel(stub) == "stbsr"
    stub.tanner = TannerELL.from_check_matrix(biregular_hgp(100, 3, 4, seed=0).checks.z)
    assert pl.StorageDecodePipeline._resolve_kernel(stub) == "stbp"
