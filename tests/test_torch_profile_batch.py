"""Port: the device-time summary of exp_ldpc_tpu_torch/experiments/
profile_batch.py on a hand-made Chrome trace (the profiling run itself
needs a card)."""
import pytest

from exp_ldpc_tpu_torch.experiments.profile_batch import parse_args, summarize


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_summarize_busy_gap_and_k3_split():
    """K3 runs three grids per iteration: with ``max_iter=1`` the first three
    are the device step and the rest the redecode."""
    chk = "void stbsr_check_kernel<12, 4, 1>(StArgs, float)"
    var, par = "void stbsr_var_kernel<4>(StArgs, bool)", "void stbsr_parity_kernel<16>(StArgs)"
    trace = {"traceEvents": [
        _ev("cpu_op", "aten::add", 0.0, 500.0),             # host: not device time
        _ev("kernel", chk, 100.0, 50.0),
        _ev("kernel", var, 140.0, 30.0),                    # overlaps the first
        _ev("kernel", par, 170.0, 5.0),                     # touches the second
        _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 400.0, 20.0),
        _ev("kernel", chk, 1000.0, 10.0),
        _ev("gpu_memset", "Memset (Device)", 1010.0, 5.0),  # touches the previous
    ]}
    out = summarize(trace, max_iter=1)
    assert out["busy_ms"] == pytest.approx((75 + 20 + 15) / 1e3)
    assert out["largest_gap_ms"] == pytest.approx(580 / 1e3)
    assert out["device_events"] == 6
    assert out["k3_launches"] == 4
    assert out["k3_device_step_ms"] == pytest.approx(85 / 1e3)
    assert out["k3_redecode_ms"] == pytest.approx(10 / 1e3)
    assert (out["dtoh_copies"], out["dtoh_ms"]) == (1, pytest.approx(0.02))
    assert out["top"][0][:2] == [chk[:90], 2]


def test_summarize_empty_trace():
    out = summarize({"traceEvents": []}, max_iter=48)
    assert (out["busy_ms"], out["largest_gap_ms"], out["k3_launches"]) == (0.0, 0.0, 0)


def test_summarize_sums_the_ported_kernels_by_route():
    """K1 (by route), K2 and K6 by route, K3 by kernel; ``stbp_resident_kernel``
    does not count as K6's ``bp_resident_kernel``, and K5's grids are not K1's."""
    trace = {"traceEvents": [
        _ev("kernel", "void stbp_resident_kernel<9, true>(unsigned char const*, float)", 0, 40),
        _ev("kernel", "void bp_resident_kernel<8, true>(unsigned char const*, float)", 50, 5),
        _ev("kernel", "void bp_resident_kernel<7, true>(unsigned char const*, float)", 60, 3),
        _ev("kernel", "void bp_streamed_var_kernel<4>(FlatArgs, bool, bool)", 70, 9),
        _ev("kernel", "void bsr_bp_check_kernel<8, true, 4, 1>(BsrArgs, int, float)", 80, 2),
        _ev("kernel", "void bsr_bp_parity_kernel<16>(BsrArgs, int)", 83, 1),
        _ev("kernel", "void stbsr_var_kernel<4>(StArgs, bool)", 90, 4),
        _ev("kernel", "elementwise_kernel", 100, 1),
        _ev("kernel", "void bsr_bp_coop_kernel<8>(BsrArgs, float, int, int)", 110, 6),
        _ev("kernel", "void bsr_int8_var_kernel<16, 8>(BsrArgs, int, bool)", 120, 7),
    ]}
    k = summarize(trace, max_iter=48)["kernels"]
    assert k == {"K1": {"grids": 2, "ms": 0.003}, "K1 coop": {"grids": 1, "ms": 0.006},
                 "K2 resident": {"grids": 1, "ms": 0.04}, "K3": {"grids": 1, "ms": 0.004},
                 "K5": {"grids": 1, "ms": 0.007}, "K6 resident": {"grids": 2, "ms": 0.008},
                 "K6 streamed": {"grids": 1, "ms": 0.009}}


@pytest.mark.parametrize("mode,p", [("bposd", 0.0034822022531844966), ("bposd_single_shot", 0.002),
                                    ("bposd_hybrid", 0.002)])
def test_mode_and_route_options(mode, p):
    """``--mode`` picks the pipeline mode and its default p, ``--route`` the
    K2/K6 route; each (mode, route) traces to its own file."""
    args = parse_args(["--mode", mode])
    assert (args.mode, args.p, args.route) == (mode, p, "auto")
    assert args.trace.name == f"profile_batch_{mode}_auto.json"
    args = parse_args(["--mode", mode, "--route", "streamed", "--p", "0.001"])
    assert (args.p, args.route, args.trace.name) == (0.001, "streamed",
                                                     f"profile_batch_{mode}_streamed.json")
    with pytest.raises(SystemExit):
        parse_args(["--mode", "relay_bp"])
