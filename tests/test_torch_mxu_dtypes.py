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
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from exp_ldpc_tpu_torch.experiments import bench_mxu_dtypes as k7
from exp_ldpc_tpu_torch.experiments import bench_bsr_ablation, bench_precision_microbench
from exp_ldpc_tpu_torch.utils.bounds import TENSOR_OPS_PER_S, dot_chain_bound

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
    b[128 k + r, n].  The plan gives one block per SM over the 8
    accumulators and S / 128 column tiles, and at least a step a part."""
    b = torch.randint(-4, 5, (8192, 256), dtype=torch.int8)
    t = k7.b_tiles_nk(b)
    assert t.shape == (64, 256, 128) and t.is_contiguous()
    for k, n, r in ((0, 0, 0), (5, 200, 17), (63, 255, 127)):
        assert t[k, n, r] == b[128 * k + r, n]
    assert k7.dot_chain_parts(16384, 128, 132) == 16
    assert k7.dot_chain_parts(16384, 256, 132) == 8
    assert k7.dot_chain_parts(64, 128, 132) == 8      # 8 steps: 8 parts of one
    assert k7.dot_chain_parts(0, 128, 132) == 1
    assert k7.dot_chain_parts(512, 1024, 8) == 1


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
