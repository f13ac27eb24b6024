"""One run of one cell: set-up, the measured window, the traced segment,
the check, and the result.

Everything a cell is made of is found by name: its entry in
``BENCHMARK.json``, its configuration file, ``traffic/<mix>.json``,
``entries/<entry>.py``, ``limits/<cell>.json``, and one reader per metric
in ``end_to_end/<name>.py`` and ``metrics/<name>.py``. A later cell, mix,
entry or metric adds files; nothing here names one.

An entry brings its own system where it defines the optional hooks
``program_system``, ``oracle_system``, ``work``, ``layer_units`` and
``trace_input`` (``entries/__init__.py``); without them a cell is a search:
the port's engine on the configuration's dataset, the plain search
reference, and pass 1's work (:func:`program_system`, :func:`oracle_system`,
:func:`layer_work`). A system's ``shape``, ``after_call()``, ``launches()``
and ``close()`` are optional too.
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


def program_system(cell: Cell, seed: int, device):
    """The system under test: the entry's ``program_system(config,
    traffic, seed, device)``, else the port's engine on the configuration's
    dataset made from the seed."""
    hook = getattr(cell.entry, "program_system", None)
    if hook is not None:
        return hook(cell.config, cell.traffic, seed, device)
    data = datagen.dataset(cell.config["dataset"], seed, device)
    return Program(cell.config, cell.traffic, data, device)


def oracle_system(cell: Cell, seed: int, device, arith):
    """The plain reference in ``arith``: the entry's ``oracle_system(config,
    traffic, seed, device, arith)``, else the search reference on the same
    dataset made again from the seed."""
    hook = getattr(cell.entry, "oracle_system", None)
    if hook is not None:
        return hook(cell.config, cell.traffic, seed, device, arith)
    data = datagen.dataset(cell.config["dataset"], seed, device)
    return Oracle(cell.config, cell.traffic, data, arith)


def layer_work(cell: Cell, shape):
    """``(bytes, flops)`` of the measured layer per unit, or ``None``: the
    entry's ``work(config, traffic, shape)``, else one pass-1 search of
    the entry's contexts over a dataset of ``shape`` where the entry has
    ``contexts_per_search``, else ``None``."""
    hook = getattr(cell.entry, "work", None)
    if hook is not None:
        return hook(cell.config, cell.traffic, shape)
    if not hasattr(cell.entry, "contexts_per_search"):
        return None
    cfg = cell.config
    d, C, w = search.embedding_kernel(cfg["embedding"]).shape
    R, _, T = shape
    return work.pass1(R, C, T, T - w - int(cfg["horizon"]) + 1,
                      cell.entry.contexts_per_search(cell.traffic), w, d)


def _call(cell: Cell, system, x, control: bool = False):
    out = (cell.entry.oracle if control else cell.entry.program)(system, x)
    after = getattr(system, "after_call", None)
    if after is not None:
        after()
    return out


def window(cell: Cell, system, mix, seconds: float, device, setup_s: float,
           min_calls: int = 1, control: bool = False) -> Window:
    """Closed loop, one caller: calls until ``seconds`` have passed and
    ``min_calls`` were made (the last call ends the window). A call that
    raises counts as failed. ``control``: the system is the reference."""
    win = Window(setup_s=setup_s)
    t0 = time.perf_counter()
    i = 0
    while True:
        x = mix.inputs(i)
        i += 1
        win.attempted += mix.units_per_call
        t = time.perf_counter()
        try:
            out = _call(cell, system, x, control)
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


def traced(cell: Cell, system, mix, win: Window, device) -> trace.Reading:
    """Profile ``trace_calls`` calls after the window, with the layer's
    work and the untraced seconds per unit beside them. The calls take the
    mix's next inputs, and the untraced seconds are the window's; or they
    take the entry's ``trace_input(mix, i)``, and the same calls run once
    untraced just before the profile give the untraced seconds. The units
    are ``trace_units``'s, or what the entry's ``layer_units(outputs)``
    counts in the calls."""
    calls, per_call = cell.entry.trace_units(cell.traffic)
    n_done = len(win.inputs) + win.failed // mix.units_per_call
    pick = getattr(cell.entry, "trace_input", None)
    count = getattr(cell.entry, "layer_units", None)

    def segment(outs: list):
        for j in range(calls):
            x = pick(mix, n_done + j) if pick else mix.inputs(n_done + j)
            outs.append(_call(cell, system, x))

    def units(outs: list, n_calls: float) -> float:
        return count(outs) if count is not None else n_calls * per_call

    if pick is not None:
        plain = []
        t = time.perf_counter()
        segment(plain)
        sync(device)
        untraced_s_per_unit = (time.perf_counter() - t) / units(plain, calls)
    else:
        untraced_s_per_unit = win.elapsed_s / units(
            win.outputs, win.units / mix.units_per_call)
    outs = []
    (ops, host), window_s = trace.profile(lambda: segment(outs))
    nbytes, flops = layer_work(cell, getattr(system, "shape", None)) or (None, None)
    return trace.Reading(ops=ops, host=host, window_s=window_s,
                         units=units(outs, calls), unit=cell.entry.UNIT,
                         untraced_s_per_unit=untraced_s_per_unit,
                         pass1_bytes=nbytes, pass1_flops=flops,
                         latencies_s=win.latencies_s)


def run(cell: Cell, seed: int, seconds: float, trace_on: bool, device,
        t_start: float, control: bool = False, min_calls: int = 1) -> dict:
    """One run of ``cell``; returns the result object (see ``run.py``).
    ``control`` puts the reference in TF32 in the program's place;
    ``min_calls`` lengthens a short window to that many calls."""
    cfg, tr = cell.config, cell.traffic
    on_card = torch.device(device).type == "cuda"
    system = (oracle_system(cell, seed, device, TF32) if control
              else program_system(cell, seed, device))
    mix = cell.entry.mix(cfg, tr, seed, device)
    _call(cell, system, mix.warm, control)
    sync(device)
    setup_s = time.perf_counter() - t_start
    shape = getattr(system, "shape", None)
    log(f"set-up {setup_s:.3f} s ({f'dataset {shape}, ' if shape else ''}"
        "warm-up call included)")
    launches = getattr(system, "launches", dict)
    before = launches()
    log(f"card before the window: {card_line() if on_card else device}")
    win = window(cell, system, mix, seconds, device, setup_s, min_calls, control)
    after = launches()
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
        reading = traced(cell, system, mix, win, device)
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
    # inputs made again from the seed
    close = getattr(system, "close", None)
    if close is not None:
        close()
    del system
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = oracle_system(cell, seed, device, FLOAT64)
    values = cell.entry.readings(cfg, tr, ref, win.inputs, win.outputs, seed)
    ok, rows = check.judge(values, cell.limits)
    log(f"check of a sample against the float64 reference: "
        f"{time.perf_counter() - t0:.3f} s")
    result["correct"] = bool(ok and win.failed == 0 and win.outputs)
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return result
