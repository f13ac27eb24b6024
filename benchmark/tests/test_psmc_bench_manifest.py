"""``BENCHMARK.json`` against the benchmark's contract, and every name in
it resolved to its file; the run's refusals (no card, JAX loaded)."""
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import entries, harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = harness.manifest(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "bound", "source", "workloads"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves", "workloads"}


def _line(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and not re.search(r"[\n\t]", s)


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert all(_line(word) for word in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    named = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    names = [e["name"] for e in named]
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[group]}) == len(BENCH[group])
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert _line(w["why"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16


def test_end_to_end_metrics_and_bounds():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names and 1 <= len(names) <= 16
    for m in BENCH["end_to_end"]:
        assert set(m) <= METRIC_KEYS and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert (ROOT / "benchmark" / "end_to_end" / f"{m['name']}.py").exists()
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = harness.load_cell(cell, json.loads(json.dumps(BENCH)), ROOT)
    wl = next(w for w in BENCH["workloads"] if w["name"] == cell)
    cfg = next(x for x in BENCH["configs"] if x["name"] == wl["config"])
    assert cfg["file"].startswith("benchmark/") and c.config["name"] == cfg["name"]
    assert set(cfg["reduced"]) <= set(c.config)
    assert (ROOT / "benchmark" / "traffic" / f"{wl['traffic']}.json").exists()
    assert (ROOT / "benchmark" / "limits" / f"{cell}.json").exists()
    for attr in ("UNIT", "NUMBERS", "mix", "program", "oracle", "trace_units",
                 "readings"):
        assert hasattr(c.entry, attr), attr
    # a search (the default system) counts its pass-1 work by its contexts
    assert hasattr(c.entry, "program_system") or hasattr(c.entry, "contexts_per_search")
    assert set(c.limits) == set(c.entry.NUMBERS)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, (cell, m["name"])


def test_per_layer_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= LAYER_KEYS and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_file_under_paths_is_named_from_name_characters():
    for path in (ROOT / "benchmark").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            rel = path.relative_to(ROOT).as_posix()
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_entries_load_by_name():
    for name in ("rolling_backtest", "predict", "predict_and_smile", "generate"):
        assert entries.load(name).NUMBERS


@pytest.mark.parametrize("names, found", [
    (["shadowing_tpu_torch", "shadowing_tpu_torch.ops.search", "torch"], []),
    (["jax"], ["jax"]), (["jax.numpy"], ["jax"]), (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]), (["shadowing_tpu"], ["shadowing_tpu"]),
    (["shadowing_tpu.ops", "shadowing_tpu_torch"], ["shadowing_tpu"]),
    (["jax_foo", "shadowing_tpu_extra"], []),
])
def test_forbidden_modules(names, found):
    assert harness.forbidden(names) == found


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.mark.cuda
def test_run_on_the_card(card):
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "ref131k-predict-foveal126", "--seed", "7", "--seconds", "2",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert list(out)[-1] == "checks" and out["correct"] is True
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
