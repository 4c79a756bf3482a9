"""Port: rounds-axis sharded spacetime BP (exp_ldpc_tpu_torch/parallel/
rounds_shard.py) in gloo worlds of real processes, against the JAX
package's unsharded structured core on the same numpy-seeded inputs.

The cases of ``tests/test_rounds_shard.py``: rounds 7 (8 blocks, 4 a rank
on a model group of 2) and 5 (6 blocks, 3 a rank), min-sum and
sum-product, with 4 rounds too (5 blocks padded to 6); a shot count the
data axis does not divide and a prior of the wrong length are refused; a
model group of one rank (no neighbour: no halo).  Worlds of 2 ranks (model
2; and model 1 x data 2) and 2 x 2 ranks (data 2, model 2), through
``parallel/mesh.py::run_world`` (one torch thread a rank).

Tolerances, those of the JAX test: against the JAX core (f32 sums in
another order) min-sum posteriors to rtol 1e-4, atol 1e-3 and hard
decisions equal off the knife-edge (|posterior| > 1e-2), sum-product hard
decisions on 99.9% of bits; conv on 90% of shots, and every converged
shot satisfies its syndrome.  Against the port's own unsharded core
(``stbp_core``, the same operations per block) min-sum is equal bit for
bit.
"""
import numpy as np
import pytest
import torch

from exp_ldpc_tpu.codes.hgp import biregular_hgp
from exp_ldpc_tpu.decoders.spacetime import SpacetimeCode
from exp_ldpc_tpu.decoders.spacetime_bp import SpacetimeBPDecoder as JaxSTBP
from exp_ldpc_tpu_torch.decoders.spacetime_bp import SpacetimeBPDecoder
from exp_ldpc_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh, run_world
from exp_ldpc_tpu_torch.parallel.rounds_shard import RoundsShardedSpacetimeBP

TIMEOUT = 120
CASES = [(7, "ms", 0.625), (7, "ps", 0.0), (5, "ms", 0.625), (5, "ps", 0.0), (4, "ms", 0.0)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _H():
    return biregular_hgp(8, 3, 4, seed=3, compute_logicals=False).checks.z


def _syndromes(rounds, S, seed, p=0.01):
    Hst = SpacetimeCode(_H(), rounds).spacetime_check_matrix.toarray()
    rng = np.random.default_rng(seed)
    errs = (rng.random((S, Hst.shape[1])) < p).astype(np.uint8)
    return (errs @ Hst.T) % 2, Hst


def _world(rank, world, model):
    """Every case on this rank's mesh; with 2 ranks also the refusals and
    a model group of one rank."""
    mesh = make_mesh(model_parallel=model, device="cpu")
    out = {"shape": (mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS])}
    for rounds, method, msf in CASES:
        synd, _ = _syndromes(rounds, 16, seed=rounds)
        dec = RoundsShardedSpacetimeBP.from_check_matrix(
            _H(), rounds, mesh, error_rate=0.01, max_iter=12, bp_method=method,
            ms_scaling_factor=msf)
        out[rounds, method] = dec.decode_batch(synd)
    if world == 2:
        dec = RoundsShardedSpacetimeBP.from_check_matrix(_H(), 3, mesh, error_rate=0.01,
                                                         max_iter=4)
        refused = []
        for bad in (lambda: dec.decode_batch(np.zeros((3, 4 * _H().shape[0]), np.uint8))
                    if mesh.shape[DATA_AXIS] > 1 else dec.decode_batch(np.zeros((3, 5))),
                    lambda: RoundsShardedSpacetimeBP.from_check_matrix(
                        _H(), 3, mesh, channel_probs=np.full(5, 0.01))):
            try:
                bad()
            except ValueError:
                refused.append(True)
        out["refused"] = refused
        one = make_mesh(model_parallel=1, device="cpu")     # data 2, model 1
        synd, _ = _syndromes(4, 8, seed=0)
        out["model1"] = RoundsShardedSpacetimeBP.from_check_matrix(
            _H(), 4, one, error_rate=0.01, max_iter=8, bp_method="ms",
            ms_scaling_factor=0.625).decode_batch(synd)
    return out


@pytest.fixture(scope="module", params=[(2, 2), (4, 2)], ids=["model2", "data2xmodel2"])
def world(request):
    n, model = request.param
    return run_world(_world, n, (model,), timeout=TIMEOUT)


def _jax_ref(rounds, method, msf, synd, iters=12):
    ref = JaxSTBP.from_check_matrix(_H(), rounds, error_rate=0.01, max_iter=iters,
                                    bp_method=method, ms_scaling_factor=msf, early_stop=False,
                                    backend="xla", formulation="matmul")
    return tuple(np.asarray(x) for x in ref.decode_batch(synd))


@pytest.mark.parametrize("rounds,method,msf", CASES)
def test_sharded_matches_unsharded(world, rounds, method, msf):
    synd, Hst = _syndromes(rounds, 16, seed=rounds)
    rhard, rpost, rconv, riters = _jax_ref(rounds, method, msf, synd)
    port = SpacetimeBPDecoder.from_check_matrix(
        _H(), rounds, error_rate=0.01, max_iter=12, bp_method=method, ms_scaling_factor=msf,
        early_stop=False, device="cpu").decode_batch(synd)
    for r in world:
        hard, post, conv, iters = r[rounds, method]
        if method == "ms":
            np.testing.assert_allclose(post, rpost, rtol=1e-4, atol=1e-3)
            margin = np.abs(rpost) > 1e-2
            assert (hard == rhard)[margin].all()
            for got, want in zip((hard, post, conv, iters), port):
                np.testing.assert_array_equal(got, want)
        else:
            assert (hard == rhard).mean() >= 0.999
        assert (conv == rconv).mean() >= 0.9
        np.testing.assert_array_equal(iters, riters)
        ok = ((hard.astype(np.int64) @ Hst.T) % 2 == synd).all(axis=1)
        assert (ok == conv).all()


def test_mesh_shapes_and_refusals(world):
    n = len(world)
    assert world[0]["shape"] == (n // 2, 2)
    if n == 2:
        assert all(r["refused"] == [True, True] for r in world)


def test_single_model_shard_degenerates(world):
    """A model group of one rank (data 2): no neighbour, no halo; equal to
    the JAX core's decisions and conv."""
    if len(world) != 2:
        pytest.skip("the model-1 mesh is built in the 2-rank world")
    synd, _ = _syndromes(4, 8, seed=0)
    rhard, _rp, rconv, _ri = _jax_ref(4, "ms", 0.625, synd, iters=8)
    for r in world:
        hard, _post, conv, _ = r["model1"]
        np.testing.assert_array_equal(hard, rhard)
        np.testing.assert_array_equal(conv, rconv)


def test_unsharded_in_one_process():
    """``mesh=None``: every block in this process, equal to ``stbp_core``."""
    synd, _ = _syndromes(5, 16, seed=5)
    got = RoundsShardedSpacetimeBP.from_check_matrix(
        _H(), 5, None, error_rate=0.01, max_iter=12, bp_method="ms", ms_scaling_factor=0.625,
        device="cpu").decode_batch(synd)
    want = SpacetimeBPDecoder.from_check_matrix(
        _H(), 5, error_rate=0.01, max_iter=12, bp_method="ms", ms_scaling_factor=0.625,
        early_stop=False, device="cpu").decode_batch(synd)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
