"""Kernels K2 and K3 against their plain PyTorch versions on a CUDA card.

Marked ``gpu``: skipped where no CUDA device is present (the CPU suite);
on a machine with a card run ``python -m pytest --noconftest -m gpu
tests/test_torch_cuda_kernels.py`` (the suite's conftest imports JAX).  The
kernels round exactly where their plain versions do (no multiply-add
contraction, the same left-to-right sums), so on the card hard decisions,
conv and iters are equal and posteriors equal to 1e-6*max(1,|x|), the
bounds ``chip_smoke.py`` holds them to.  S=77 leaves a ragged shot edge
(77 mod 32 = 13) for the kernels' masking.
"""
import numpy as np
import pytest
import torch

from exp_ldpc_tpu_torch import _host
from exp_ldpc_tpu_torch.convert import tanner_tables
from exp_ldpc_tpu_torch.decoders.bp import priors_to_llr
from exp_ldpc_tpu_torch.decoders.bp_bsr_spacetime import (
    KERNEL as K3, _stbsr_iter_plain, stbsr_decode)
from exp_ldpc_tpu_torch.decoders.spacetime_bp import stbp_core
from exp_ldpc_tpu_torch.decoders.spacetime_bp_cuda import KERNEL as K2, stbp_fixed

pytestmark = pytest.mark.gpu
ROUNDS = 4


@pytest.fixture(scope="module")
def setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    H = _host.biregular_hgp(12, 3, 4, seed=0).checks.z
    Hst = _host.SpacetimeCode(H, ROUNDS).spacetime_check_matrix.tocsr().astype(np.int64)
    rng = np.random.default_rng(0)
    err = (rng.random((256, Hst.shape[1])) < 3e-3).astype(np.int64)
    synd = torch.as_tensor(((Hst @ err.T) % 2).astype(np.uint8)).to(dev)
    prior = torch.as_tensor(priors_to_llr(np.full(Hst.shape[1], 2e-3))).to(dev)
    tables = tanner_tables(_host.TannerELL.from_check_matrix(H), dev)
    return tables, prior, synd


def _assert_same(kern, plain):
    hk, pk, ck, ik = kern
    hp, pp, cp, ip = plain
    assert bool(((pk - pp).abs() <= 1e-6 * pp.abs().clamp(min=1.0)).all())
    assert torch.equal(hk, hp) and torch.equal(ck, cp) and torch.equal(ik, ip)


@pytest.mark.parametrize("S", [77, 256])
@pytest.mark.parametrize("method,msf", [("ms", 0.625), ("ms", 0.0), ("ps", 0.0)])
def test_k2_matches_plain(setup, method, msf, S):
    tables, prior, synd = setup
    synd = synd[:, :S].contiguous()
    before = K2.launches
    kern = stbp_fixed(tables, ROUNDS, prior, synd, method, 24, msf)
    plain = stbp_core(tables, ROUNDS, prior, synd, method, 24, msf, early_stop=False)
    torch.cuda.synchronize()
    assert K2.launches == before + 1
    _assert_same(kern, plain)


@pytest.mark.parametrize("S", [77, 256])
@pytest.mark.parametrize("method,msf,early_stop", [("ms", 0.625, False), ("ps", 0.0, False),
                                                   ("ms", 0.625, True)])
def test_k3_matches_plain(setup, method, msf, early_stop, S):
    tables, prior, synd = setup
    synd = synd[:, :S].contiguous()
    before = K3.launches
    kern = stbsr_decode(tables, ROUNDS, prior, synd, method, 24, msf, early_stop)
    plain = stbsr_decode(tables, ROUNDS, prior, synd, method, 24, msf, early_stop,
                         iterate=_stbsr_iter_plain)
    torch.cuda.synchronize()
    assert K3.launches == before + int(kern[3][0])
    _assert_same(kern, plain)
