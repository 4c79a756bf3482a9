"""Port: experiments/bench_stbsr.py against scripts/bench_stbsr.py.

The LER chain (``ler_sanity`` / ``ler_chain``): both draw their records from
the host ``FrameSampler`` (the same numpy code in both packages) seeded by
the chain's key, 10 + i: the script through a stand-in for its
``DeviceSampler`` and the JAX ``SpacetimeBSRDecoder`` in Pallas interpret
mode, the port through its ``records`` argument and K3's plain version.  On
small HGP codes (the toric code is the HGP of two ring codes) the records
are EQUAL, and so are every row's ``failures``, ``bp_unconverged`` and
``iters``.  The chain's device steps (differenced syndromes, final
correction, logical test as float products) equal the script's numpy steps.
The options: ``--ler`` and ``--iters`` rows carry the script's keys on the
CPU; without a card the default device refuses to run.  The ``gpu`` test
runs the chain on the card against the CPU's on the same records.

The JAX package is imported inside the tests that need it, so that
``python -m pytest --noconftest -m gpu`` runs this file where JAX is absent.
"""
import contextlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from exp_ldpc_tpu_torch.experiments import bench_stbsr as port

REPO = Path(__file__).resolve().parent.parent

# scripts/bench_stbsr.py's records: the throughput record (:105-117) and an LER row (:165-170)
SCRIPT_RECORD_KEYS = {
    "bench", "code", "n", "r", "rounds", "n_spacetime", "shots", "tiles", "shot_block",
    "iters_lo", "iters_hi", "t_lo_s", "t_hi_s", "per_iter_ms", "iter_shots_per_s",
    "decoded_shots_per_s_at32", "compile_s_lo", "compile_s_hi", "conv_frac_warmup", "p"}


def _script():
    spec = importlib.util.spec_from_file_location("_script_bench_stbsr",
                                                  REPO / "scripts" / "bench_stbsr.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ler_keys():
    """The keys of the script's LER rows, as its artifact holds them."""
    line = (REPO / "artifacts" / "stbsr_ler_v5e.jsonl").read_text().splitlines()[0]
    return list(json.loads(line))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _codes(name):
    """(JAX code, port code) of one small HGP with its logicals."""
    if name == "toric4":
        from exp_ldpc_tpu.codes.surface import toric_code as jax_code
        from exp_ldpc_tpu_torch.codes.surface import toric_code
        return jax_code(4), toric_code(4)
    from exp_ldpc_tpu.codes.hgp import biregular_hgp as jax_hgp
    from exp_ldpc_tpu_torch.codes.hgp import biregular_hgp
    return (jax_hgp(12, 3, 4, seed=0, compute_logicals=True),
            biregular_hgp(12, 3, 4, seed=0, compute_logicals=True))


def _port_records(sim, shots, key, dev):
    from exp_ldpc_tpu_torch.sampler.reference import FrameSampler

    return torch.as_tensor(FrameSampler(sim.circuit, seed=key).sample(shots))


@pytest.mark.parametrize("name,rounds,shots", [("toric4", 4, 1024), ("hgp225", 2, 128)])
def test_ler_chain_matches_script(monkeypatch, name, rounds, shots):
    import exp_ldpc_tpu.decoders.bp_bsr_spacetime as jax_st
    import exp_ldpc_tpu.sampler.device as jax_sampler
    from exp_ldpc_tpu.sampler.reference import FrameSampler

    jax_code, code = _codes(name)
    np.testing.assert_array_equal(np.asarray(jax_code.logicals.z), np.asarray(code.logicals.z))
    drawn = []

    class HostSampler:
        """The script's DeviceSampler, standing in: FrameSampler records
        seeded by the key's integer (PRNGKey(k) holds k last)."""

        def __init__(self, circuit, shots):
            self.circuit, self.shots = circuit, shots

        def sample(self, key):
            rec = FrameSampler(self.circuit, seed=int(np.asarray(key).ravel()[-1])).sample(
                self.shots)
            drawn.append(rec)
            return rec

    build = jax_st.SpacetimeBSRDecoder.from_check_matrix

    class Interpreted(jax_st.SpacetimeBSRDecoder):
        @classmethod
        def from_check_matrix(cls, *a, **kw):
            return build(*a, interpret=True, **kw)

    script = _script()
    monkeypatch.setattr(jax_sampler, "DeviceSampler", HostSampler)
    monkeypatch.setattr(jax_st, "SpacetimeBSRDecoder", Interpreted)
    monkeypatch.setattr(script, "_cyclic", lambda logicals=False: jax_code)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        script.ler_sanity(None, shots=shots, rounds=rounds)
    want = [json.loads(ln) for ln in buf.getvalue().splitlines()]

    port_drawn = []

    def records(sim, n_shots, key, dev):
        rec = _port_records(sim, n_shots, key, dev)
        port_drawn.append((key, rec.numpy()))
        return rec

    got = port.ler_chain(shots, rounds, "cpu", code=code, records=records)
    assert [key for key, _ in port_drawn] == [10, 11, 12]
    for a, (_key, b) in zip(drawn, port_drawn):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert [list(r) for r in got] == [_ler_keys()] * 3
    for w, g in zip(want, got):
        assert (g["p"], g["shots"], g["rounds"]) == (w["p"], w["shots"], w["rounds"])
        for key in ("failures", "bp_unconverged", "iters"):
            assert g[key] == w[key], (key, g, w)
    if name == "toric4":   # the chain reaches unconverged shots and logical failures
        assert got[-1]["failures"] > 0 and got[-1]["iters"] == port.LER_ITERS


def test_chain_steps_match_script_numpy():
    """The chain's syndromes, final correction and logical test, float
    products on the decode device, equal the script's numpy int64 steps on
    random 0/1 records and decisions."""
    from exp_ldpc_tpu.codes.hgp import biregular_hgp
    from exp_ldpc_tpu.decoders.spacetime import SpacetimeCode

    code = biregular_hgp(12, 3, 4, seed=0, compute_logicals=True)
    Hz, rounds, S = code.checks.z, 3, 40
    r, n = Hz.shape
    st = SpacetimeCode(Hz, rounds)
    rng = np.random.default_rng(5)
    hist = (rng.random((S, rounds, r)) < 0.3).astype(np.int64)
    readout = (rng.random((S, n)) < 0.003).astype(np.int64)
    hard = (rng.random((S, st.spacetime_check_matrix.shape[1])) < 0.001).astype(np.uint8)
    HzT = torch.as_tensor(Hz.T.toarray(), dtype=torch.float32)
    synd = port.spacetime_syndromes(HzT, torch.as_tensor(hist, dtype=torch.float32),
                                    torch.as_tensor(readout, dtype=torch.float32))
    np.testing.assert_array_equal(synd.numpy().T, st.syndrome_from_history_batch(hist, readout))
    Lz = np.asarray(code.logicals.z, dtype=np.int64)
    corrected = (readout + st.final_correction(hard)) % 2
    want = (((corrected @ Lz.T) % 2) != 0).any(axis=1)
    got = port.logical_failures(rounds, torch.as_tensor(hard.T.copy()),
                                torch.as_tensor(readout, dtype=torch.float32),
                                torch.as_tensor(Lz.T, dtype=torch.float32))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < S


NO_CARD = "needs a CUDA device"


@pytest.mark.parametrize("case", ["ler", "iters", "default", "default_ler", "per_phase_cpu",
                                  "only_without_iters"])
def test_options(case, tmp_path, capsys):
    """``--ler`` at a tiny size (1 round, 8 shots; the n = 4,862 code) and
    the ``--iters`` throughput record (1 round, 4 shots) on the CPU carry the
    script's keys and append to ``--out``; the default device refuses to run
    without a card (as ``tests/test_torch_stbsr.py`` checks for ``main([])``),
    the per-phase mode runs on a card only, and ``--only`` / ``--shots`` ask
    for ``--iters``."""
    out = tmp_path / "rows.jsonl"
    if case in ("default", "default_ler"):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(SystemExit, match=NO_CARD):
            port.main(["--ler"] if case == "default_ler" else [])
        return
    if case == "per_phase_cpu":
        with pytest.raises(SystemExit, match="per-phase mode " + NO_CARD):
            port.main(["--device", "cpu"])
        return
    if case == "only_without_iters":
        with pytest.raises(SystemExit) as exc:
            port.main(["--device", "cpu", "--only", "cyclic_lp_4862"])
        assert exc.value.code == 2 and "--iters" in capsys.readouterr().err
        return
    if case == "ler":
        argv = ["--device", "cpu", "--ler", "--ler-shots", "8", "--rounds", "1"]
    else:
        argv = ["--device", "cpu", "--iters", "1,2", "--only", "cyclic_lp_4862", "--rounds",
                "1", "--shots", "4"]
    assert port.main(argv + ["--out", str(out)]) == 0
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("{")]
    assert [json.loads(ln) for ln in out.read_text().splitlines()] == printed
    if case == "ler":
        assert [list(r) for r in printed] == [_ler_keys()] * 3
        assert [r["p"] for r in printed] == list(port.LER_PS)
        assert all(r["code"] == "cyclic_lp_4862" and r["shots"] == 8 and r["rounds"] == 1
                   for r in printed)
        lers = [r["ler"] for r in printed]
        assert lers == sorted(lers)
    else:
        (rec,) = printed
        assert SCRIPT_RECORD_KEYS <= set(rec)
        text = (REPO / "scripts" / "bench_stbsr.py").read_text()
        assert all(f'"{key}"' in text for key in SCRIPT_RECORD_KEYS)
        assert (rec["code"], rec["n"], rec["r"], rec["n_spacetime"]) == (
            "cyclic_lp_4862", 4862, 1540, 2 * 4862 + 1540)
        assert rec["tiles"] is None and rec["shot_block"] is None and rec["plan"] is None
        assert rec["per_iter_ms"] == pytest.approx(
            1e3 * (rec["t_hi_s"] - rec["t_lo_s"]) / (rec["iters_hi"] - rec["iters_lo"]))


@pytest.mark.gpu
def test_chain_on_the_card_matches_cpu():
    """The chain on the card (K3's kernels, the exit armed) and on the CPU
    (its plain version) from the same host records: equal rows; K3
    launched once a point."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from exp_ldpc_tpu_torch.codes.surface import toric_code
    from exp_ldpc_tpu_torch.decoders.bp_bsr_spacetime import KERNEL

    code = toric_code(4)
    cpu = port.ler_chain(1024, 4, "cpu", code=code, records=_port_records)
    KERNEL.reset_counts()
    card = port.ler_chain(1024, 4, "cuda", code=code, records=_port_records)
    assert KERNEL.launches == 3
    for a, b in zip(cpu, card):
        assert {k: v for k, v in a.items() if k != "decode_walltime_s"} == \
            {k: v for k, v in b.items() if k != "decode_walltime_s"}
