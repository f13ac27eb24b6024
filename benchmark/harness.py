"""One run of one cell: set-up, the measured window, the traced segment,
the check, and the result.

Everything a cell is made of is found by name: its entry in
``BENCHMARK.json``, its configuration file, ``traffic/<mix>.json``,
``entries/<entry>.py``, ``limits/<cell>.json``, and one reader per metric
in ``end_to_end/<name>.py`` and ``metrics/<name>.py``. A later cell, mix,
entry or metric adds files; nothing here names one.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType

import torch

from benchmark import check, datagen, entries, trace, work
from benchmark.reference import search
from benchmark.reference.precision import FLOAT64, TF32
from benchmark.system import Oracle, Program

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level module names that no run may have loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "shadowing_tpu")


def forbidden(module_names) -> list:
    """The :data:`FORBIDDEN` top-level names among ``module_names``, each
    compared whole (``shadowing_tpu_torch`` is not ``shadowing_tpu``)."""
    return sorted({m.split(".")[0] for m in module_names} & set(FORBIDDEN))


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _load(kind: str, name: str) -> ModuleType:
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(kind: str, name: str):
    """The ``read`` function of ``<kind>/<name>.py``."""
    return _load(kind, name).read


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list             # the manifest's metric entries this cell reports
    per_layer: list
    entry: ModuleType = field(init=False)

    def __post_init__(self):
        self.entry = entries.load(self.traffic["entry"])


def cells_of(metric: dict, bench: dict) -> list:
    """The cells that report ``metric``: its ``workloads``, else every cell
    that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return metric["workloads"]
    moved = next(m for m in bench["end_to_end"] if m["name"] == metric["moves"])
    return cells_of(moved, bench)


def _limits(name: str) -> dict:
    """The cell's limits (``{}`` before they are set: then no run of it
    reads correct)."""
    path = BENCH / "limits" / f"{name}.json"
    return json.loads(path.read_text())["limits"] if path.exists() else {}


def load_cell(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    bench = bench or manifest(root)
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == wl["config"])
    for m in bench["end_to_end"]:
        m.setdefault("workloads", [w["name"] for w in bench["workloads"]])
    return Cell(
        name=name, chips=int(wl["chips"]),
        config=json.loads((root / cfg["file"]).read_text()),
        traffic=json.loads((BENCH / "traffic" / f"{wl['traffic']}.json").read_text()),
        limits=_limits(name),
        end_to_end=[m for m in bench["end_to_end"] if name in cells_of(m, bench)],
        per_layer=[m for m in bench["per_layer"] if name in cells_of(m, bench)])


@dataclass
class Window:
    """The measured window of a run (host clock, seconds)."""

    setup_s: float
    elapsed_s: float = 0.0
    units: int = 0                        # dates or queries completed
    latencies_s: list = field(default_factory=list)   # per call
    attempted: int = 0
    failed: int = 0
    inputs: list = field(default_factory=list)
    outputs: list = field(default_factory=list)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name, power limit and draw, clocks and temperature."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,clocks.mem,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi unavailable: {err}"
    return out.stdout.strip()


def _call(cell: Cell, system, x):
    if isinstance(system, Program):
        out = cell.entry.program(system, x)
    else:
        out = cell.entry.oracle(system, x)
    system.after_call()
    return out


def window(cell: Cell, system, mix, seconds: float, device, setup_s: float,
           min_calls: int = 1) -> Window:
    """Closed loop, one caller: calls until ``seconds`` have passed and
    ``min_calls`` were made (the last call ends the window). A call that
    raises counts as failed."""
    win = Window(setup_s=setup_s)
    t0 = time.perf_counter()
    i = 0
    while True:
        x = mix.inputs(i)
        i += 1
        win.attempted += mix.units_per_call
        t = time.perf_counter()
        try:
            out = _call(cell, system, x)
            sync(device)
        except Exception:       # the loop goes on; the run reads not correct
            win.failed += mix.units_per_call
            if win.failed == mix.units_per_call:
                traceback.print_exc()
        else:
            win.latencies_s.append(time.perf_counter() - t)
            win.units += mix.units_per_call
            win.inputs.append(x)
            win.outputs.append(out)
        if time.perf_counter() - t0 >= seconds and i >= min_calls:
            break
    win.elapsed_s = time.perf_counter() - t0
    return win


def traced(cell: Cell, system, mix, win: Window, data_shape: tuple,
           device) -> trace.Reading:
    """Profile ``trace_calls`` calls after the window, with the layer's
    work and the window's seconds per unit beside them."""
    calls, per_call = cell.entry.trace_units(cell.traffic)
    n_done = len(win.inputs) + win.failed // mix.units_per_call

    def segment():
        for j in range(calls):
            _call(cell, system, mix.inputs(n_done + j))

    (ops, host), window_s = trace.profile(segment)
    cfg = cell.config
    kernel = search.embedding_kernel(cfg["embedding"])
    d, C, w = kernel.shape
    R, _, T = data_shape
    nbytes, flops = work.pass1(R, C, T, T - w - int(cfg["horizon"]) + 1,
                               cell.entry.contexts_per_search(cell.traffic), w, d)
    units_window = win.units * per_call / mix.units_per_call
    return trace.Reading(ops=ops, host=host, window_s=window_s,
                         units=calls * per_call, unit=cell.entry.UNIT,
                         untraced_s_per_unit=win.elapsed_s / units_window,
                         pass1_bytes=nbytes, pass1_flops=flops,
                         latencies_s=win.latencies_s)


def run(cell: Cell, seed: int, seconds: float, trace_on: bool, device,
        t_start: float, control: bool = False, min_calls: int = 1) -> dict:
    """One run of ``cell``; returns the result object (see ``run.py``).
    ``control`` puts the reference in TF32 in the program's place;
    ``min_calls`` lengthens a short window to that many calls."""
    cfg, tr = cell.config, cell.traffic
    on_card = torch.device(device).type == "cuda"
    data = datagen.dataset(cfg["dataset"], seed, device)
    shape = tuple(data.shape)
    mix = cell.entry.mix(cfg, tr, seed, device)
    system = (Oracle(cfg, tr, data, TF32) if control
              else Program(cfg, tr, data, device))
    _call(cell, system, mix.warm)
    sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s (dataset {shape}, warm-up call included)")
    before = system.launches()
    log(f"card before the window: {card_line() if on_card else device}")
    win = window(cell, system, mix, seconds, device, setup_s, min_calls)
    after = system.launches()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    log(f"card after the window: {card_line() if on_card else device}")
    log(f"window {win.elapsed_s:.3f} s: {len(win.latencies_s)} calls, "
        f"{win.units} units, {win.failed} failed; launches in the window "
        f"{ {k: after[k] - before[k] for k in after} }; peak allocated "
        f"{peak / 2**30:.3f} GiB")
    log(f"evidence: {json.dumps(system.evidence())}")

    result = {"correct": False, "attempted": win.attempted,
              "failed": win.failed, "metrics": {},
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": torch.cuda.get_device_name() if on_card else "cpu",
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if trace_on and not control:
        reading = traced(cell, system, mix, win, shape, device)
        for m in cell.per_layer:
            value = reader("metrics", m["name"])(reading)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        result["device"].update(busy_s=reading.busy_s, window_s=reading.window_s)
        result["breakdown"] = trace.breakdown(reading)
        log(f"traced {reading.units} {reading.unit}s in {reading.window_s:.3f} s: "
            f"{len(reading.kernels())} kernels, device busy {reading.busy_s:.4f} s")
    elif not trace_on:
        for m in cell.end_to_end:
            value = reader("end_to_end", m["name"])(win)
            result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}

    # the reference runs once the program's state is freed, on the same
    # dataset made again from the seed
    system.close()
    del system, data
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = Oracle(cfg, tr, datagen.dataset(cfg["dataset"], seed, device), FLOAT64)
    values = cell.entry.readings(cfg, tr, ref, win.inputs, win.outputs, seed)
    ok, rows = check.judge(values, cell.limits)
    log(f"check of a sample against the float64 reference: "
        f"{time.perf_counter() - t0:.3f} s")
    result["correct"] = bool(ok and win.failed == 0 and win.outputs)
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return result
