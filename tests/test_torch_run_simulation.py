"""Port: ``run_simulation`` (exp_ldpc_tpu_torch/decoders/drivers.py) in all
seven decoder modes and the host path of ``p_sweep`` (no ``pipeline``)
against the JAX package, on the host ``FrameSampler``'s records (identical
for the same seed on both sides).

Tolerances.  ``ssf_single_shot`` (integer arithmetic), ``relay_bp`` and
``bpd_detector`` (min-sum, no OSD) give equal per-shot failure lists.  The
OSD modes (``bposd``, ``bposd_single_shot``, ``bposd_hybrid``,
``sliding_window``) agree within max(2, 10%) failures: OSD orders its
columns by BP posteriors whose last bits differ (f32 sums in another
order).  In the X-basis test ``relay_bp`` gives equal failures on every
shot but one: there (seed 5) shot 85 is solved by none of the 8 legs on
either side, so its outcome is the last leg's lambda after 8 legs of 30
iterations, where the f32 reassociation of the variable sums has grown to
flip 4 of its 372 hard decisions (lambda 0.561 against -0.551 at variable
100), and with them its logical outcome.  The test shows that case: the
shots no leg solves are the same on both sides and include shot 85, and
every other shot's outcome is equal.  The
device sampler draws other bits than JAX's from the same seed, so its path
is held statistically: within 4 binomial sigma of the host sampler's
failures at two rates.
"""
import io

import numpy as np
import pytest
import torch

from exp_ldpc_tpu.circuits.noise import depolarizing_noise
from exp_ldpc_tpu.codes.hgp import biregular_hgp
from exp_ldpc_tpu.decoders.drivers import run_simulation as jax_run_simulation
from exp_ldpc_tpu.experiments.p_sweep import p_sweep as jax_p_sweep
from exp_ldpc_tpu_torch.decoders.drivers import DECODER_MODES, run_simulation
from exp_ldpc_tpu_torch.experiments.p_sweep import cli_main, p_sweep, write_csv

OPTS = {"max_iter": 30, "bp_method": "ms", "ms_scaling_factor": 0.625,
        "osd_method": "osd_cs", "osd_order": 2}
EXACT = ("ssf_single_shot", "relay_bp", "bpd_detector")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once; torch's default of one
    thread per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def code():
    return biregular_hgp(6, 2, 3, seed=1, compute_logicals=True)


def _kw(code, p, mode, **over):
    kw = dict(samples=96, code=code, meas_prior=lambda xs, zs: 2 / 3 * p,
              data_prior=lambda xs, zs: 2 / 3 * p, noise_model=depolarizing_noise,
              noise_model_args={"p": p, "pm": p}, bp_osd_options=dict(OPTS), rounds=2,
              decoder_mode=mode, seed=3, use_device_sampler=False)
    kw.update(over)
    return kw


def _agree(got, want, mode, exact=EXACT):
    assert len(got) == len(want)
    if mode in exact:
        assert [bool(x) for x in got] == [bool(x) for x in want], mode
    else:
        f_got, f_want = sum(got), sum(want)
        assert abs(f_got - f_want) <= max(2, 0.1 * f_want), (mode, f_got, f_want)


@pytest.mark.parametrize("mode", sorted(DECODER_MODES))
def test_modes_match_jax(code, mode):
    """Every mode on identical FrameSampler records (Z basis, p = 0.02)."""
    got = run_simulation(device="cpu", **_kw(code, 0.02, mode))
    want = jax_run_simulation(**_kw(code, 0.02, mode))
    _agree(got, want, mode)
    assert 0 < sum(got) < len(got), mode


# the X-basis relay_bp shot whose outcome differs (module docstring)
RELAY_X_SHOT = 85


def _record_conv(monkeypatch, cls, store: list) -> None:
    """Keep each ``cls.decode_batch`` call's per-shot ``conv`` in ``store``."""
    orig = cls.decode_batch

    def decode_batch(self, syndromes):
        out = orig(self, syndromes)
        store.append(np.asarray(out[2], dtype=bool))
        return out

    monkeypatch.setattr(cls, "decode_batch", decode_batch)


@pytest.mark.parametrize("mode", ["bposd", "ssf_single_shot", "relay_bp", "sliding_window"])
def test_x_basis_matches_jax(code, mode, monkeypatch):
    """The X-basis memory experiment: |+> prepared and read, X checks and
    logicals on the X-check block of the record (``relay_bp``: every shot's
    failure equal but the one no leg solves, see the module docstring)."""
    from exp_ldpc_tpu.decoders.relay_bp import RelayBPDecoder as JaxRelay
    from exp_ldpc_tpu_torch.decoders.relay_bp import RelayBPDecoder

    kw = _kw(code, 0.02, mode, use_x_logicals=True, seed=5)
    conv, conv_jax = [], []
    _record_conv(monkeypatch, RelayBPDecoder, conv)
    _record_conv(monkeypatch, JaxRelay, conv_jax)
    got = run_simulation(device="cpu", **kw)
    want = jax_run_simulation(**kw)
    assert sum(got) > 0
    if mode != "relay_bp":
        _agree(got, want, mode, exact=("ssf_single_shot",))
        return
    (conv,), (conv_jax,) = conv, conv_jax
    unsolved = np.flatnonzero(~conv).tolist()
    assert unsolved == np.flatnonzero(~conv_jax).tolist() and RELAY_X_SHOT in unsolved
    rest = [i for i in range(len(got)) if i != RELAY_X_SHOT]
    assert [bool(got[i]) for i in rest] == [bool(want[i]) for i in rest]


@pytest.mark.parametrize("mode", ["bposd", "bpd_detector"])
def test_device_sampler_path(code, mode):
    """The device sampler (a torch.Generator on the CPU here) feeds the
    syndrome-history and the detector-model paths: at p = 0.005 and 0.02
    its failures are within 4 binomial sigma of the host sampler's."""
    n = 256
    for p, dev_flag in ((0.005, True), (0.02, None)):     # None: the default, the device
        f_dev = sum(run_simulation(device="cpu", **_kw(code, p, mode, samples=n,
                                                       use_device_sampler=dev_flag)))
        f_host = sum(run_simulation(device="cpu", **_kw(code, p, mode, samples=n, seed=8)))
        pool = (f_dev + f_host) / (2 * n)
        sigma = np.sqrt(max(pool * (1 - pool), 1e-3) * 2 / n)
        assert abs(f_dev - f_host) / n < 4 * sigma, (p, f_dev, f_host)


def test_unknown_mode_and_options_raise(code):
    with pytest.raises(RuntimeError, match="Unknown decoder operation mode"):
        run_simulation(device="cpu", **_kw(code, 0.02, "bp_plain"))
    with pytest.raises(ValueError, match="unsupported options"):
        run_simulation(device="cpu", **_kw(code, 0.02, "bposd",
                                           bp_osd_options=dict(OPTS, relay_legs=2)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_simulation(**_kw(code, 0.02, "ssf_single_shot"))


def _sweep_kw(code, **over):
    kw = dict(samples=64, code=code, rounds=2, noise_model=depolarizing_noise,
              noise_model_args=lambda p: {"p": p, "pm": p},
              meas_prior=lambda p, xs, zs: 2 / 3 * p, data_prior=lambda p, xs, zs: 2 / 3 * p,
              decoder_mode="ssf_single_shot", bp_osd_options=dict(OPTS), seed=5,
              use_device_sampler=False)
    kw.update(over)
    return kw


def test_p_sweep_host_path_matches_jax(code):
    """The host path's CSV has JAX's columns in JAX's order; each point i
    runs with seed ``seed + i`` (equal failures to ``run_simulation`` at that
    seed, and to JAX's sweep for this exact mode)."""
    ps = np.array([0.01, 0.03])
    df = jax_p_sweep(p_values=ps, **_sweep_kw(code))
    recs = p_sweep(p_values=ps, device="cpu", **_sweep_kw(code))
    want = df.to_csv().splitlines()
    out = io.StringIO()
    write_csv(recs, out)
    got = out.getvalue().splitlines()
    assert got[0] == want[0] and len(got) == len(want) == 3
    assert [r["failures"] for r in recs] == [int(x) for x in df["failures"]]
    assert [r["samples"] for r in recs] == [64, 64]
    for i, p in enumerate(ps):
        alone = run_simulation(
            64, code, lambda xs, zs, p=p: 2 / 3 * p, lambda xs, zs, p=p: 2 / 3 * p,
            depolarizing_noise, {"p": p, "pm": p}, dict(OPTS), 2, "ssf_single_shot",
            seed=5 + i, use_device_sampler=False, device="cpu")
        assert recs[i]["failures"] == sum(alone)
    assert recs[1]["failures"] > 0


def test_p_sweep_host_path_checkpoint_resume(code, tmp_path):
    ck = tmp_path / "sweep.jsonl"
    ps = np.array([0.01, 0.03])
    first = p_sweep(p_values=ps[:1], device="cpu", checkpoint=ck, **_sweep_kw(code))
    both = p_sweep(p_values=ps, device="cpu", checkpoint=ck, **_sweep_kw(code))
    assert len(ck.read_text().splitlines()) == 2
    assert both[0]["failures"] == first[0]["failures"] and len(both) == 2
    again = p_sweep(p_values=ps, device="cpu", checkpoint=ck, **_sweep_kw(code))
    assert [r["failures"] for r in again] == [r["failures"] for r in both]
    assert len(ck.read_text().splitlines()) == 2


def test_cli_without_pipeline(code, tmp_path, capsys):
    """``qldpc-p-sweep-torch`` without ``--pipeline`` runs ``run_simulation``
    per point (here the relay mode on the host sampler) and prints the CSV."""
    from exp_ldpc_tpu_torch.codes.io import write_quantum_code

    path = tmp_path / "code.qecc"
    with path.open("w") as f:
        write_quantum_code(f, code)
    cli_main([str(path), "--samples", "32", "--p_sweep", "(0.01,0.02,2)", "--rounds", "1",
              "--decoder_mode", "relay_bp", "--cpu_sampler", "--seed", "2", "--device", "cpu",
              "--bposd_max_iter", "12", "--bposd_bp_method", "ms"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split(",")[:5] == ["", "p_ph", "failures", "samples", "walltime"]
    assert len(lines) == 3 and all(ln.split(",")[3] == "32" for ln in lines[1:])
    assert "relay_bp" in lines[1]
