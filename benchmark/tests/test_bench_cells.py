"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix, entry and metric reader parses and is found by its name."""
import importlib
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(x["name"] for x in BENCH["end_to_end"] + BENCH["per_layer"])) == \
        len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in [c["source"] for c in BENCH["configs"]] + [w["why"] for w in BENCH["workloads"]] \
            + [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"shots_per_s", "setup_s"}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}


def test_per_layer_metrics_have_readers():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        assert callable(importlib.import_module(f"benchmark.metrics.{m['name']}").read)
    for cell in CELLS:
        assert any(cell in m.get("workloads", CELLS) for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    assert traffic["config"] == w["config"]
    entry = importlib.import_module(f"benchmark.entries.{traffic['entry']}")
    assert hasattr(entry, "Entry")
    assert all(v is not None for v in traffic["limits"].values()), traffic["limits"]
    assert traffic["compare_batches"] >= 1 and traffic["trace_units"] >= 1


@pytest.mark.parametrize("cfg", [c["name"] for c in BENCH["configs"]])
def test_config_files(cfg):
    c = next(c for c in BENCH["configs"] if c["name"] == cfg)
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"].startswith("benchmark/")
    body = json.loads((ROOT / c["file"]).read_text())
    assert body["name"] == cfg and body["reduced"] == c["reduced"]
    assert all(k in body for k in c["reduced"])
    assert any(w["config"] == cfg for w in BENCH["workloads"])
    if body["code"]["kind"] == "qecc":
        assert (ROOT / "benchmark" / "configs" / body["code"]["file"]).is_file()
