"""Port parity: K1's profiling hook ``ablate`` (``decoders/bp_bsr.py``)
against the JAX ``bsr_bp_decode(..., interpret=True, ablate=...)`` on a
small HGP code, and the rows of ``experiments/bench_bsr_ablation.py``.

``"no_check"`` skips the check update (the variable update reads the v2c
messages as c2v); ``"no_route"`` replaces both routing passes by a copy
(posterior = prior, messages negated, parity 0), and in fixed-iteration
mode the final parity pass too.  Hard decisions, conv and iters are equal.
Posteriors: ``no_route`` bit for bit (they are the priors); ``no_check``
within 2^-22 relative, since the TPU kernel sums two edges of one variable
in one 128 x 128 tile before they meet the running total (as
``test_torch_bp_bsr.py`` says): here that moves only the posteriors of the
first iteration, whose edges carry equal bf16 priors, by one f32 step.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exp_ldpc_tpu.codes.hgp import biregular_hgp
from exp_ldpc_tpu.decoders.bp import priors_to_llr
from exp_ldpc_tpu.decoders.bp_bsr import BSRSchedule, bsr_bp_decode
from exp_ldpc_tpu.decoders.tanner import TannerELL
from exp_ldpc_tpu_torch.decoders import bp_bsr
from exp_ldpc_tpu_torch.decoders.bp_bsr import (ABLATIONS, BSRBPDecoder, BSRLayout,
                                                bsr_bp_plain)
from exp_ldpc_tpu_torch.experiments import bench_bsr_ablation
from exp_ldpc_tpu_torch.utils.cuda_build import bsr_plan

PKG = Path(__file__).resolve().parent.parent / "exp_ldpc_tpu_torch"
SB, S, ITERS = 32, 64, 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hgp100():
    """``biregular_hgp(8, 3, 4)`` (48 checks of up to 7 slots, 100 qubits);
    syndromes at p = 0.02 whose first shot block is all zero (it stops after
    one iteration with the exit), as are three shots of the second."""
    H = biregular_hgp(8, 3, 4, seed=0).checks.z
    rng = np.random.default_rng(1)
    err = (rng.random((S, H.shape[1])) < 0.02).astype(np.int64)
    synd = ((err @ H.T) % 2).astype(np.uint8).T.copy()
    synd[:, :SB + 3] = 0
    prior = priors_to_llr(np.full(H.shape[1], 0.02))
    return H, synd, prior


@pytest.mark.parametrize("ablate", ["no_check", "no_route"])
@pytest.mark.parametrize("method,msf", [("ms", 0.625), ("ps", 0.0)])
@pytest.mark.parametrize("early_stop", [False, True])
def test_plain_ablation_matches_jax(hgp100, ablate, method, msf, early_stop):
    H, synd, prior = hgp100
    tanner = TannerELL.from_check_matrix(H)
    want = [np.asarray(x) for x in bsr_bp_decode(
        BSRSchedule.from_tanner(tanner), jnp.asarray(prior), jnp.asarray(synd), method, ITERS,
        msf, early_stop, SB, True, ablate)]
    layout = BSRLayout.from_tanner(tanner, "cpu")
    got = [x.numpy() for x in bsr_bp_plain(layout, torch.as_tensor(prior),
                                           torch.as_tensor(synd), method, ITERS, msf,
                                           early_stop, SB, ablate)]
    for i in (0, 2, 3):   # hard, conv, iters
        np.testing.assert_array_equal(got[i], want[i])
    if ablate == "no_route":
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[1], np.broadcast_to(prior[:, None], got[1].shape))
        # the stand-in's parity is 0: exactly the shots of zero syndrome converge
        np.testing.assert_array_equal(got[2], (synd == 0).all(axis=0))
    else:
        np.testing.assert_allclose(got[1], want[1], rtol=2.0 ** -22, atol=0)
    blocks = list(got[3][::SB])
    assert blocks == ([1, ITERS] if early_stop else [ITERS, ITERS]), blocks
    assert 0 < got[2].mean() < 1
    # the ablations differ from the full decode
    full = bsr_bp_plain(layout, torch.as_tensor(prior), torch.as_tensor(synd), method, ITERS,
                        msf, early_stop, SB)
    assert not torch.equal(full[1], torch.as_tensor(got[1]))


def test_unknown_ablation_raises(hgp100):
    H, synd, prior = hgp100
    layout = BSRLayout.from_tanner(TannerELL.from_check_matrix(H), "cpu")
    args = (layout, torch.as_tensor(prior), torch.as_tensor(synd), "ms", 2, 0.625, False, SB)
    for fn in (bsr_bp_plain, bp_bsr.bsr_bp_decode):
        with pytest.raises(ValueError, match="unknown ablate"):
            fn(*args, "no_parity")
    assert set(ABLATIONS) == {"", "no_check", "no_route"}


@pytest.mark.parametrize("shots", [128, 256, 685, 4096])
def test_plan_never_coop_under_ablation(shots):
    """HGP-225's (H|I) at a few hundred shots takes the cooperative route
    when asked; under an ablation it never does (the JAX package forces its
    unrolled kernel there), and checks past 32 slots keep route "wide"."""
    plans = {ab: bsr_plan(108, 333, 8, 4, shots, 128, 132, False, True, ab) for ab in ABLATIONS}
    if shots <= 685:
        assert plans[""].route == "coop"
    for ab in ("no_check", "no_route"):
        assert plans[ab].route == "grids"
        assert plans[ab]._replace(route="grids") == plans[""]._replace(route="grids")
        assert bsr_plan(216, 1518, 53, 4, shots, 128, 132, False, True, ab).route == "wide"


def test_production_callers_pass_no_ablation(hgp100, monkeypatch):
    """``BSRBPDecoder`` decodes with ``ablate=""``, and no module of the port
    but K1's own and the ablation benchmark names an ablation."""
    H, synd, prior = hgp100
    seen = []
    plain = bp_bsr.bsr_bp_plain

    def spy(*a, **kw):
        seen.append(a[8] if len(a) > 8 else kw.get("ablate", ""))
        return plain(*a, **kw)

    monkeypatch.setattr(bp_bsr, "bsr_bp_plain", spy)
    dec = BSRBPDecoder.from_check_matrix(H, error_rate=0.02, max_iter=4, bp_method="ms",
                                         ms_scaling_factor=0.625, device="cpu")
    dec.decode_batch(synd.T)
    assert seen == [""]
    users = sorted(str(p.relative_to(PKG)) for p in PKG.rglob("*.py")
                   if "no_check" in p.read_text() or "no_route" in p.read_text())
    assert users == ["decoders/bp_bsr.py", "experiments/bench_bsr_ablation.py", "utils/bounds.py"]


def test_ablation_rows_on_cpu():
    """The script's rows and keys on the plain version (a test of the rows,
    not a rate of the card): full, no_check, no_route on the cyclic
    n = 4,862 code's 548 tiles."""
    rows = bench_bsr_ablation.rows(torch.device("cpu"), 16, 2, (1, 2))
    assert [r["ablate"] for r in rows] == ["full", "no_check", "no_route"]
    for r in rows:
        assert {"ablate", "tiles", "us_per_iter_128shots", "iter_shots_per_s",
                "compile_s"} <= set(r)
        assert {"bound_ms", "bound_by", "bound_share", "card", "device"} <= set(r)
        assert (r["tiles"], r["device"], r["shots"], r["iters"]) == (548, "cpu", 16, 2)
    assert rows[1]["bound_ms"] <= rows[0]["bound_ms"]
