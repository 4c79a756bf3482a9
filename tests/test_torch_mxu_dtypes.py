"""Port parity: the dot chain of ``scripts/bench_mxu_dtypes.py`` (kernel K7,
``exp_ldpc_tpu_torch/experiments/bench_mxu_dtypes.py``) and the rows of its
benchmark and of ``bench_precision_microbench``, on the CPU.

The script's Pallas kernel is a closure inside its ``main()``, so this file
carries a transcription of ``make`` with ``interpret=True`` added, and a test
holds the transcription to the script's text.  The port's plain version of
K7 runs the chain in f32 with ``torch.matmul``; the Pallas kernel in
interpret mode casts each dot to f32 and adds it.  int8 is held exactly (every
product and every dot is an integer below 2^24); bf16 and f32 within
``dot_chain_tolerance``: 2^-22 times (128 + chain/8 + parts + 8) times the same
chain on |a| and |b| (each side rounds every product through at most that
many additions).
"""
import inspect
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from exp_ldpc_tpu_torch.experiments import bench_mxu_dtypes as k7
from exp_ldpc_tpu_torch.experiments import bench_bsr_ablation, bench_precision_microbench
from exp_ldpc_tpu_torch.utils.bounds import TENSOR_OPS_PER_S, clock_peak, dot_chain_bound

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "bench_mxu_dtypes.py"
S = 128
JAX_TYPES = {"bf16": (jnp.bfloat16, jnp.float32), "f32": (jnp.float32, jnp.float32),
             "int8": (jnp.int8, jnp.int32)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make(chain, dtype, acc_dtype):
    def kern(a_ref, b_ref, o_ref):
        def body(i, accs):
            out = []
            for j in range(8):  # static accumulator index, 8 dots/step
                a = a_ref[pl.dslice(j * 128, 128), :]
                b = b_ref[pl.dslice(((i + j * 8) % 64) * 128, 128), :]
                d = jnp.dot(a, b, preferred_element_type=acc_dtype
                            ).astype(jnp.float32)
                out.append(accs[j] + d)
            return tuple(out)
        accs = jax.lax.fori_loop(
            0, chain // 8, body,
            tuple(jnp.zeros((128, S), jnp.float32) for _ in range(8)))
        tot = accs[0]
        for k in range(1, 8):
            tot = tot + accs[k]
        o_ref[:, :] = tot
    return pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((128, S), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )


def test_transcription_is_the_scripts_make():
    """``make`` above is the script's (``scripts/bench_mxu_dtypes.py:33-57``)
    with one line added, ``interpret=True,``, and the script's constants are
    the port's."""
    text = SCRIPT.read_text().splitlines()
    start = text.index("    def make(chain, dtype, acc_dtype):")
    end = text.index("    def run_case(name, dtype, acc_dtype):")
    script = textwrap.dedent("\n".join(text[start:end]).rstrip() + "\n")
    mine = inspect.getsource(make).replace("        interpret=True,\n", "")
    assert mine == script
    assert "interpret=True" not in script
    consts = {line.split(" = ")[0]: int(line.split(" = ")[1]) for line in text
              if line.split(" = ")[0] in ("CHAIN_LO", "CHAIN_HI", "S")}
    assert consts == {"CHAIN_LO": k7.CHAIN_LO, "CHAIN_HI": k7.CHAIN_HI, "S": k7.S} == {
        "CHAIN_LO": 16384, "CHAIN_HI": 131072, "S": S}


def _operands(dtype: str, seed: int):
    """The script's draws (int8 in [-4, 4], else standard normal), as numpy."""
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        return (rng.integers(-4, 5, (1024, 128), dtype=np.int8),
                rng.integers(-4, 5, (64 * 128, S), dtype=np.int8))
    a = rng.standard_normal((1024, 128)).astype(np.float32)
    b = rng.standard_normal((64 * 128, S)).astype(np.float32)
    if dtype == "bf16":   # rounded once, then both sides read the same values
        a = torch.as_tensor(a).bfloat16().float().numpy()
        b = torch.as_tensor(b).bfloat16().float().numpy()
    return a, b


@pytest.mark.parametrize("dtype", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("chain", [64, 512])
def test_plain_matches_the_pallas_kernel(dtype, chain):
    a_np, b_np = _operands(dtype, seed=chain)
    jt, acc = JAX_TYPES[dtype]
    want = np.asarray(make(chain, jt, acc)(jnp.asarray(a_np, jt), jnp.asarray(b_np, jt)))
    ta, tb = torch.as_tensor(a_np).to(k7.DTYPES[dtype]), torch.as_tensor(b_np).to(k7.DTYPES[dtype])
    got = k7.dot_chain_plain(ta, tb, chain, dtype)
    assert got.dtype == torch.float32 and got.shape == (128, S)
    if dtype == "int8":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        tol = k7.dot_chain_tolerance(ta, tb, chain, dtype).numpy()
        assert (np.abs(got.numpy() - want) <= tol).all()
        assert not np.array_equal(got.numpy(), np.zeros_like(want))
    # on CPU tensors the wrapper is the plain version
    assert torch.equal(k7.dot_chain(ta, tb, chain, dtype), got)


def test_int8_kernel_layout_and_plan():
    """b_tiles_nk transposes each 128-row tile of b: element (k, n, r) is
    b[128 k + r, n].  The plan gives one block per SM over the S / 128
    column tiles, at least 8 blocks a column tile and at most one a dot,
    and splits the dots evenly: every accumulator's partials counted."""
    b = torch.randint(-4, 5, (8192, 256), dtype=torch.int8)
    t = k7.b_tiles_nk(b)
    assert t.shape == (64, 256, 128) and t.is_contiguous()
    for k, n, r in ((0, 0, 0), (5, 200, 17), (63, 255, 127)):
        assert t[k, n, r] == b[128 * k + r, n]
    assert k7.dot_chain_plan(16384, 128, 132).blocks == 132
    assert k7.dot_chain_plan(16384, 256, 132).blocks == 66
    assert k7.dot_chain_plan(64, 128, 132).blocks == 64      # 64 dots: one a block
    assert k7.dot_chain_plan(0, 128, 132).blocks == 1
    assert k7.dot_chain_plan(512, 1024, 8).blocks == 8        # at least 8 a column tile
    assert k7.dot_chain_plan(16384, 128, 132) == (2048, 132, 1)
    assert k7.dot_chain_plan(16384, 128, 132).parts == 17     # 2,048 steps over 15.5 blocks
    assert k7.dot_chain_plan(64, 128, 132).parts == 8
    assert k7.dot_chain_plan(0, 128, 132).parts == 1
    assert k7.dot_chain_walk(k7.dot_chain_plan(16384, 128, 132), 16) == [(0, 1985, 63),
                                                                        (1, 0, 62)]
    with pytest.raises(ValueError, match="1,024"):
        k7.dot_chain_plan(1 << 20, 128, 2048)


@settings(max_examples=80, deadline=None)
@given(chain=st.integers(0, 4104), S=st.sampled_from([128, 256]),
       sms=st.sampled_from([8, 114, 132]))
def test_plan_covers_every_dot_once(chain, S, sms):
    """Every (accumulator, step) of the chain is computed by exactly one
    block, blocks take consecutive dots in order, a block meets at most two
    accumulators, and ``parts`` counts the most partials of one
    accumulator."""
    plan = k7.dot_chain_plan(chain, S, sms)
    assert plan.col_tiles == S // 128 and plan.blocks >= 1
    assert plan.blocks <= max(8, sms // plan.col_tiles, 1)
    seen, per = [], [0] * 8
    for blk in range(plan.blocks):
        walk = k7.dot_chain_walk(plan, blk)
        assert len(walk) <= 2
        for j, first, n in walk:
            assert n > 0
            seen += [(j, i) for i in range(first, first + n)]
            per[j] += 1
    assert seen == [(j, i) for j in range(8) for i in range(chain // 8)]
    assert plan.parts == max(1, max(per))


@pytest.mark.parametrize("dtype,chain,S", [("bf16", 16, 128), ("f32", 520, 128),
                                           ("bf16", 4104, 128), ("f32", 1000, 256),
                                           ("int8", 4104, 128)])
def test_plan_order_within_tolerance(dtype, chain, S):
    """The chain summed in the kernel's order (each block's walk, then the
    partials in the fixed order) stays within ``dot_chain_tolerance`` of
    the plain version (int8: equal)."""
    a_np, b_np = _operands(dtype, seed=chain + S)
    if S != 128:
        b_np = np.concatenate([b_np, b_np[:, ::-1]], axis=1)
    ta, tb = torch.as_tensor(a_np).to(k7.DTYPES[dtype]), torch.as_tensor(b_np).to(k7.DTYPES[dtype])
    plan = k7.dot_chain_plan(chain, S, 132)
    got = k7.dot_chain_planned(ta, tb, chain, dtype, plan)
    plain = k7.dot_chain_plain(ta, tb, chain, dtype)
    if dtype == "int8":
        assert torch.equal(got, plain)
    else:
        tol = k7.dot_chain_tolerance(ta, tb, chain, dtype, plan.parts)
        assert bool(((got - plain).abs() <= tol).all())
        assert not torch.equal(got, torch.zeros_like(got))


def test_library_int8_column_major():
    """The int8 yardstick gets B column-major, laid out before the call,
    and computes the same product."""
    a_np, b_np = _operands("int8", seed=3)
    ta, tb = torch.as_tensor(a_np), torch.as_tensor(b_np)
    fn, out = k7.library_chain(ta, tb, 16, "int8")
    A, B = k7._wide(ta, tb, 16)
    assert out == "int32"
    assert torch.equal(fn(), A.int() @ B.int())
    held = [c.cell_contents for c in fn.__closure__ if isinstance(c.cell_contents, torch.Tensor)]
    assert [t.stride() for t in held if t.shape == B.shape] == [(1, B.shape[0])]


def test_dot_chain_bounds():
    """Bound by operations at every chain the probe and its checks run, at
    the type's published peak."""
    for dtype, peak in (("bf16", 989.4e12), ("int8", 1978.9e12), ("f32", 67e12)):
        assert TENSOR_OPS_PER_S[dtype] == peak
        for chain in (512, 4096, k7.CHAIN_LO, k7.CHAIN_HI):
            b = dot_chain_bound(dtype, chain, S)
            assert b["bound_by"] == "operations"
            assert b["bound_ops"] == 2 * 128 * 128 * S * chain
            assert b["bound_ms"] == pytest.approx(1e3 * b["bound_ops"] / peak)


def test_clock_peak():
    """The published peaks are the operations a clock and SM on 132 SMs:
    bf16 and int8 at 1,830 MHz, f32 at 1,980 MHz; at 1,980 MHz the tensor
    cores' peaks are 8.2% higher, and the chain's bound takes that rate."""
    for dtype, mhz in (("bf16", 1830), ("int8", 1830), ("f32", 1980)):
        assert clock_peak(dtype, 132, mhz) == pytest.approx(TENSOR_OPS_PER_S[dtype], rel=2e-3)
    assert clock_peak("bf16", 132, 1980) == pytest.approx(1070.5e12, rel=1e-4)
    assert clock_peak("int8", 132, 1980) == pytest.approx(2141.0e12, rel=1e-4)
    fast = dot_chain_bound("bf16", k7.CHAIN_LO, S, clock_peak("bf16", 132, 1980))
    assert fast["bound_ms"] == pytest.approx(
        dot_chain_bound("bf16", k7.CHAIN_LO, S)["bound_ms"] * 1830 / 1980, rel=2e-3)


def test_refusals():
    a = torch.zeros((1024, 128), dtype=torch.float32)
    b = torch.zeros((8192, 128), dtype=torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        k7.dot_chain(a, b, 8, "f16")
    with pytest.raises(ValueError, match="operands"):
        k7.dot_chain(a, b, 8, "bf16")
    with pytest.raises(ValueError, match="1024, 128"):
        k7.dot_chain(a[:512], b, 8, "f32")
    assert k7.KERNEL.launches == 0   # the CPU never touches the kernel


def test_mxu_rows_on_cpu(capsys):
    """The script's keys, in its order of rows, plus the bound, its share,
    the library's rate and the device and card (here the CPU: a test of the
    rows, not a rate of the card)."""
    rows = k7.rows(torch.device("cpu"), 16, 32, 1)
    assert [r["dtype"] for r in rows] == ["bf16", "f32", "int8"]
    script_keys = {"dtype", "s", "tflops", "ns_per_dot", "chain_lo", "chain_hi", "t_hi_s",
                   "t_lo_s"}
    for r in rows:
        assert script_keys <= set(r)
        assert {"peak_tflops", "bound_ns_per_dot", "bound_share", "library_tflops",
                "library_ns_per_dot", "library_out_dtype", "card", "device"} <= set(r)
        assert (r["device"], r["card"], r["s"], r["chain_lo"], r["chain_hi"]) == (
            "cpu", "cpu", 128, 16, 32)
        assert r["library_tflops"] > 0
        assert r["sm_clock_max_mhz"] is r["clock_share"] is None   # the card's clock only
    assert rows[2]["library_out_dtype"] == "int32"
    assert len(capsys.readouterr().out.strip().splitlines()) == 3


def test_entry_points_need_a_card_by_default():
    """``--device`` defaults to cuda, which raises without a card."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    for mod in (k7, bench_bsr_ablation, bench_precision_microbench):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main([])


def test_precision_microbench_rows_on_cpu():
    rows = bench_precision_microbench.rows(torch.device("cpu"), (1, 2), (32,), 32)
    assert [(r["name"], r["n"]) for r in rows] == [
        ("f32/f32", 32), ("bf16/f32", 32), ("int8/int32", 32),
        ("f32/f32", 32), ("bf16/f32", 32), ("int8/int32", 32)]
    assert [(r["m"], r["k"], r["k_padded"]) for r in rows[:3]] == [(225, 756, 756),
                                                                   (225, 756, 756),
                                                                   (225, 756, 760)]
    for r in rows:
        assert {"us_per_matmul", "tops", "out_dtype", "device", "card"} <= set(r)
        assert r["device"] == "cpu"
    assert rows[2]["out_dtype"] == "int32"
